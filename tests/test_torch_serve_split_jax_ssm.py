"""mamba2-370m served on a grid (`repro_torch.sharding.serving`) against
the JAX package's jitted prefill and decode on a fake-device mesh
(`_torch_serve_twins`): the rules split its SSM caches on "model" (the
conv's channels, the state's heads) while its SSM blocks run whole on
the model line, so a decode step gathers the blocks over the model line
inside the layer, computes alike and writes back the rank's blocks.
Smoke config, f32, a 16-token prompt and 3 decode steps of fed tokens;
held within LOGIT_TOL (of max(1, |JAX's|)), as
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
