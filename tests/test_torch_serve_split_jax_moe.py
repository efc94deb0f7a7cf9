"""qwen2-moe-a2.7b served on a grid (`repro_torch.sharding.serving`)
against the JAX package's jitted prefill and decode on a fake-device mesh
(`_torch_serve_twins`): its kv heads divide the model axis, so each rank
projects its kv heads and its cache block holds them (case (a)); its
experts and its shared experts' MLP split over the model line; and the
prompt's 64 tokens overflow the capacity, so the prefill drops
assignments (checked here), which on 2x2 the data ranks must drop as the
global program does (the capacity and the slots are the global batch's).
Smoke config, f32, a 16-token prompt and 3 decode steps of fed tokens
(decode drops nothing); held within LOGIT_TOL (of max(1, |JAX's|)), as
tests/test_torch_serve_split_jax.py holds gemma3-1b (1.5e-6 at most
here)."""
from __future__ import annotations

import pytest

import _torch_serve_twins as T
from test_torch_split_jax import _dropped

LOGIT_TOL = 2e-5
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
RUNS = [("1x2", "qwen2-moe-a2.7b"), ("2x2", "qwen2-moe-a2.7b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {"qwen2-moe-a2.7b": T.case("qwen2-moe-a2.7b", 4)}
    return T.run(tmp_path_factory.mktemp("serve_split_jax_moe"), GRIDS,
                 cases, RUNS)


@pytest.mark.parametrize("grid,name", RUNS)
def test_served_grid_is_the_jax_meshs_prefill_and_decode(runs, grid, name):
    got = T.check(runs, grid, name, LOGIT_TOL)
    assert got["blocks_split"] > 0


def test_the_prefill_drops_and_each_rank_holds_its_kv_heads(runs):
    arch, params, prompt, _, _ = runs["cases"]["qwen2-moe-a2.7b"]
    assert _dropped(arch, {"params": params}, {"tokens": prompt}) > 0
    for grid, name in RUNS:
        for r in (x[name] for x in runs["ranks"][grid]):
            k = r["caches"]["k"]                 # (layers, B, S, kvh, hd)
            assert k.shape[1:] == (4 // GRIDS[grid][0], T.MAX_LEN, 2, 16), (
                grid, k.shape)
