"""gemma3-1b served on a grid (`repro_torch.sharding.serving`) against the
JAX package's jitted prefill and decode on a fake-device mesh
(`_torch_serve_twins`): its one kv head does not divide the model axis
and its head_dim does, so the rules put the caches' head_dim on "model"
(case (b): each rank writes its head_dim block, the scores are summed
over the model line); and a batch of 1 on 2x2, which does not divide the
data axis, so the rules put the caches' S on "data" (case (c): the
masked write lands on the rank that owns the position, and the decode
attention is a split-softmax combine over the data line).  Smoke
config, f32, a 16-token prompt and 3 decode steps of fed tokens; held
within LOGIT_TOL (of max(1, |JAX's|)), the logits and the caches: the
attention's reductions and the model line's partial sums are added in
another order than GSPMD's, a few f32 roundings (2^-24 each) of values
near 1 through 6 layers; the three twins measure 2.1e-6 at most."""
from __future__ import annotations

import pytest

import _torch_serve_twins as T

LOGIT_TOL = 2e-5
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
RUNS = [("1x2", "gemma3-1b"), ("2x2", "gemma3-1b"),
        ("2x2", "gemma3-1b batch 1")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {"gemma3-1b": T.case("gemma3-1b", 4),
             "gemma3-1b batch 1": T.case("gemma3-1b", 1)}
    return T.run(tmp_path_factory.mktemp("serve_split_jax"), GRIDS, cases,
                 RUNS)


@pytest.mark.parametrize("grid,name", RUNS)
def test_served_grid_is_the_jax_meshs_prefill_and_decode(runs, grid, name):
    got = T.check(runs, grid, name, LOGIT_TOL)
    # the caches' head_dim splits on every grid, and S on the data axis
    # at a batch of 1; else their batch rows
    assert got["blocks_split"] > 0


def test_the_cut_of_each_case(runs):
    """(b): a rank's cache block holds every kv head's half of head_dim
    (and, on 2x2 at batch 4, its two rows); (c): its half of S and all of
    the one row."""
    for grid, name in RUNS:
        for r in (x[name] for x in runs["ranks"][grid]):
            k = r["caches"]["k"]                 # (layers, B, S, kvh, hd)
            b = 1 if name.endswith("batch 1") else 4 // GRIDS[grid][0]
            s = T.MAX_LEN // (2 if name.endswith("batch 1") else 1)
            assert k.shape[1:] == (b, s, 1, 8), (grid, name, k.shape)
