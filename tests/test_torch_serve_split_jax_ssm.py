"""mamba2-370m served on a grid (`repro_torch.sharding.serving`) against
the JAX package's jitted prefill and decode on a fake-device mesh
(`_torch_serve_twins`): the rules split its SSM caches on "model" (the
conv's channels, the state's heads), and each rank of a model line
computes its 4 of the 8 SSM heads, whose state block it keeps: prefill
keeps its heads' final state, decode updates its block in place and
never exchanges the state; a decode step gathers the conv's blocks over
the model line once a layer for its channels' history and writes its
own block.  Smoke config, f32, a 16-token prompt and 3 decode steps of
fed tokens; held within LOGIT_TOL (of max(1, |JAX's|)), as
tests/test_torch_serve_split_jax.py holds gemma3-1b; at a batch of 1 the
two data ranks hold the same blocks, bitwise."""
from __future__ import annotations

import pytest

import _torch_serve_twins as T

LOGIT_TOL = 2e-5
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
RUNS = [("1x2", "mamba2-370m"), ("2x2", "mamba2-370m"),
        ("2x2", "mamba2-370m batch 1")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {"mamba2-370m": T.case("mamba2-370m", 4),
             "mamba2-370m batch 1": T.case("mamba2-370m", 1)}
    return T.run(tmp_path_factory.mktemp("serve_split_jax_ssm"), GRIDS,
                 cases, RUNS)


@pytest.mark.parametrize("grid,name", RUNS)
def test_served_grid_is_the_jax_meshs_prefill_and_decode(runs, grid, name):
    got = T.check(runs, grid, name, LOGIT_TOL)
    assert got["blocks_split"] > 0
    assert (got["blocks_shared"] > 0) == name.endswith("batch 1")


def test_each_rank_holds_its_blocks_of_the_ssm_caches(runs):
    """conv (layers, B, W - 1, convdim) and state (layers, B, nh, hp, st):
    half of the 160 conv channels and of the 8 heads on each rank of a
    model line, its rows of the batch where the batch divides the data
    axis."""
    for grid, name in RUNS:
        b = 1 if name.endswith("batch 1") else 4 // GRIDS[grid][0]
        for r in (x[name] for x in runs["ranks"][grid]):
            assert r["caches"]["conv"].shape[1:] == (b, 3, 80), grid
            assert r["caches"]["ssm"].shape[1:] == (b, 4, 16, 16), grid


@pytest.mark.parametrize("grid,name", RUNS)
def test_a_decode_step_moves_no_state(runs, grid, name):
    """Each rank computes its 4 of the 8 SSM heads, and a decode step's
    all_sums are, each of the 2 layers, the conv blocks' exchange (B_r x
    3 x 160 f32 in all), the gated norm's sum of squares (B_r f32) and
    out_proj's partial output (B_r x 64 f32), then the vocab-parallel
    lookup's sum and the whole logits' gather (B x 256 f32): no state
    (B_r x 8 x 16 x 16 f32 a layer before)."""
    dims = GRIDS[grid]
    big_b = 1 if name.endswith("batch 1") else 4
    b = big_b if big_b % dims[0] else big_b // dims[0]
    layer = [b * 3 * 160 * 4, b * 4, b * 64 * 4]
    want = {"all_sum": 2 * len(layer) + 2,
            "all_sum_bytes": 2 * sum(layer) + b * 64 * 4 + big_b * 256 * 4}
    for r in (x[name] for x in runs["ranks"][grid]):
        plan = r["plans"]["decode"]
        assert {k: plan[k] for k in want} == want, (grid, name, plan)
        m = r["coords"]["model"]
        assert r["shares"]["ssm_heads"] == [(4, 8, 4 * m)], r["shares"]
