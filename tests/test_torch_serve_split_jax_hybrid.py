"""zamba2-7b served on a 2x2 grid (`repro_torch.sharding.serving`)
against the JAX package's jitted prefill and decode on a fake-device mesh
(`_torch_serve_twins`): each rank of a model line computes 4 of the 8
SSM heads of every SSM layer and keeps their state block (never
exchanged), gathers the conv cache's blocks once a layer in a decode
step, and computes 2 of the shared attention block's 4 heads (its kv
heads divide the model line, so each rank's KV cache block holds its
own) at each of the block's calls.  Smoke config, f32, a 16-token
prompt and 3 decode steps of fed tokens, a batch of 4 (2 rows a data
rank); held within LOGIT_TOL (of max(1, |JAX's|)), as
tests/test_torch_serve_split_jax_ssm.py holds mamba2-370m."""
from __future__ import annotations

import pytest

import _torch_serve_twins as T

LOGIT_TOL = 2e-5
GRIDS = {"2x2": (2, 2)}
RUNS = [("2x2", "zamba2-7b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("serve_split_jax_hybrid"), GRIDS,
                 {"zamba2-7b": T.case("zamba2-7b", 4)}, RUNS)


@pytest.mark.parametrize("grid,name", RUNS)
def test_served_grid_is_the_jax_meshs_prefill_and_decode(runs, grid, name):
    got = T.check(runs, grid, name, LOGIT_TOL)
    assert got["blocks_split"] > 0


@pytest.mark.parametrize("grid,name", RUNS)
def test_each_rank_computes_its_heads_and_keeps_their_state(runs, grid,
                                                             name):
    """SSM state (B, 8 heads, 16, 16) a layer: the rank's 4 heads of its
    2 rows; the shared attention's KV cache: its 2 kv heads; the shares
    recorded at every call."""
    for r in (x[name] for x in runs["ranks"][grid]):
        m = r["coords"]["model"]
        assert r["shares"]["ssm_heads"] == [(4, 8, 4 * m)], r["shares"]
        assert r["shares"]["heads"] == [(2, 4, 2 * m)], r["shares"]
        states = [v for k, v in r["caches"].items()
                  if k.split(".")[-1] == "ssm"]
        assert states and all(v.shape[-4:] == (2, 4, 16, 16)
                              for v in states), r["caches"].keys()
