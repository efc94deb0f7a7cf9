"""The port's prefill and decode on a grid (`repro_torch.sharding.serving`)
against itself, without JAX (tests/test_torch_serve_split_jax*.py hold it
against the JAX package):

- on one rank `mesh_prefill` / `mesh_decode` are `models.prefill` /
  `models.decode_step`, bitwise;
- a 2x1 grid of gloo ranks (the data axis alone) serves within rounding
  of one rank (ROUND_TOL of max(1, |one rank's|): the data split adds
  nothing in another order but the split-softmax combine and MoE's
  exchanged statistics): gemma3-1b at a batch of 4 (each rank its two
  rows), gemma3-1b at a batch of 1 (the caches' S on the data axis: the
  masked write on the rank that owns the position, the split-softmax
  combine), qwen2-moe-a2.7b (the capacity from the global tokens) and
  zamba2-7b (the SSM caches and the shared attention's); and a 1x3
  grid (the model axis alone, three ranks), where gemma3-1b's one kv
  head and its head_dim of 16 do not divide the line, so the rules put
  the caches' S on "model": each rank keeps a third of the positions,
  and decode's split-softmax combine runs over the model line;
- a batch that does not split over the data axes raises, as
  `layout.batch_rows` does;
- `layout.serve_plan`, run shape only on meta tensors, equals each
  call's counted collectives (`core.mesh.tallying`), and on one rank is
  nothing."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.mesh import run_ranks
from repro_torch.launch.mesh import GridMesh, make_mesh_like
from repro_torch.models import model as M
from repro_torch.sharding import layout, serving
from repro_torch.sharding.rules import (Sharding, batch_spec, cache_shardings,
                                        param_shardings, tree_map)

from test_torch_ranks import serve_model, serve_split

ROUND_TOL = 1e-5
PROMPT, STEPS, MAX_LEN = 12, 3, 16
CASES = {"gemma3-1b": ("gemma3-1b", 4), "gemma3-1b batch 1": ("gemma3-1b", 1),
         "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", 4),
         "zamba2-7b": ("zamba2-7b", 2)}


def _case(arch, batch, seed=0):
    cfg, _ = serve_model(arch, seed)
    rng = np.random.default_rng(seed)
    return (arch, seed,
            rng.integers(0, cfg.vocab, (batch, PROMPT)).astype(np.int32),
            rng.integers(0, cfg.vocab, (batch, STEPS)).astype(np.int32),
            MAX_LEN)


def _one_rank(arch, params, prompt, fed, max_len):
    """Logits and caches (numpy by `layout.flat` path) of `models.prefill`
    and `decode_step` on one rank."""
    def host(caches):
        return {".".join(p): t.numpy().copy()
                for p, t in layout.flat(caches).items()}
    _, model = serve_model(arch, params)
    with torch.no_grad():
        lg, c = M.prefill(model, {"tokens": torch.from_numpy(prompt)},
                          max_len)
        logits, first = [lg.numpy().copy()], host(c)
        for i in range(fed.shape[1]):
            lg, c = M.decode_step(model, torch.from_numpy(fed[:, i:i + 1]), c,
                                  prompt.shape[1] + i)
            logits.append(lg.numpy().copy())
    return logits, first, host(c)


@pytest.fixture(scope="module")
def grid_2x1():
    cases = {n: _case(*c) for n, c in CASES.items()}
    return cases, run_ranks(serve_split, 2, backend="gloo", device="cpu",
                            timeout=600, args=("2x1", cases))


@pytest.fixture(scope="module")
def grid_1x3():
    # 18 positions: a third on each rank
    cases = {"gemma3-1b": _case("gemma3-1b", 2)[:4] + (18,)}
    return cases, run_ranks(serve_split, 3, backend="gloo", device="cpu",
                            timeout=600, args=("1x3", cases))


def _layout(name, cases, dims=(2, 1)):
    arch, _, prompt, _, max_len = cases[name]
    cfg, _ = serve_model(arch, 0)
    grid = GridMesh(("data", "model"), dims)
    return layout.flat(tree_map(lambda _, s: Sharding(grid, s), cache_shardings(
        M.cache_specs(cfg, prompt.shape[0], max_len), cfg, grid)))


@pytest.mark.parametrize("name", list(CASES))
def test_a_data_grid_serves_as_one_rank(grid_2x1, name):
    _holds_one_rank(grid_2x1, name, (2, 1))


def test_a_model_line_splitting_s_serves_as_one_rank(grid_1x3):
    _holds_one_rank(grid_1x3, "gemma3-1b", (1, 3))
    for i, r in enumerate(x["gemma3-1b"] for x in grid_1x3[1]):
        assert r["coords"]["model"] == i
        assert r["caches"]["k"].shape[1:3] == (2, 18 // 3)
        assert r["tallies"][1:] == [r["plans"]["decode"]] * STEPS


def _holds_one_rank(grid, name, dims):
    cases, ranks = grid
    logits, first, last = _one_rank(*cases[name])
    sh = _layout(name, cases, dims)
    for r in (x[name] for x in ranks):
        for got, want in zip(r["logits"], logits, strict=True):
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= ROUND_TOL * scale, (
                name, r["coords"])
        for which, whole in (("prefill_caches", first), ("caches", last)):
            assert set(r[which]) == set(whole)
            for k, w in whole.items():
                blk = w[layout.block_slices(w.shape, sh[tuple(k.split("."))],
                                            r["coords"])]
                assert r[which][k].shape == blk.shape, (name, which, k)
                scale = max(1.0, float(np.abs(w).max()))
                assert float(np.abs(r[which][k] - blk).max()) \
                    <= ROUND_TOL * scale, (name, which, k)


@pytest.mark.parametrize("name", list(CASES))
def test_the_serve_plan_is_each_calls_collectives(grid_2x1, name):
    _, ranks = grid_2x1
    for r in (x[name] for x in ranks):
        assert r["tallies"][0] == r["plans"]["prefill"], name
        assert r["tallies"][1:] == [r["plans"]["decode"]] * STEPS, name
        # the rows' logits are gathered over the data line, the parameters
        # split on "data" gathered unit by unit
        assert r["plans"]["decode"]["all_sum"] > 0
        assert r["plans"]["decode"]["broadcast"] > 0


def test_a_batch_of_one_keeps_its_block_of_s(grid_2x1):
    _, ranks = grid_2x1
    for i, r in enumerate(x["gemma3-1b batch 1"] for x in ranks):
        assert r["coords"]["data"] == i
        k = r["caches"]["k"]                       # (layers, B, S, kvh, hd)
        assert k.shape[1:3] == (1, MAX_LEN // 2)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m", "zamba2-7b"])
def test_one_rank_is_prefill_and_decode_step_bitwise(arch):
    cfg, model = serve_model(arch, 0)
    grid = make_mesh_like("1x1", device="cpu", grid=True)
    sh = {"params": param_shardings(model, cfg, grid),
          "caches": tree_map(lambda _, s: Sharding(grid, s), cache_shardings(
              M.cache_specs(cfg, 2, MAX_LEN), cfg, grid))}
    bsh = {kind: {k: Sharding(grid, s) for k, s in batch_spec(
        cfg, grid, kind=kind, batch=2).items()}
        for kind in ("prefill", "decode")}
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, PROMPT)))
    step = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))
    with torch.no_grad():
        want = M.prefill(model, {"tokens": prompt}, MAX_LEN)
        got = serving.mesh_prefill(sh, bsh["prefill"])(
            model, {"tokens": prompt}, MAX_LEN)
        for w, g in ((want[0], got[0]), *zip(
                layout.flat(want[1]).values(), layout.flat(got[1]).values(),
                strict=True)):
            assert torch.equal(w, g)
        want = M.decode_step(model, step, want[1], PROMPT)
        got = serving.mesh_decode(sh, bsh["decode"])(model, step, got[1],
                                                     PROMPT)
        for w, g in ((want[0], got[0]), *zip(
                layout.flat(want[1]).values(), layout.flat(got[1]).values(),
                strict=True)):
            assert torch.equal(w, g)
    assert layout.serve_plan(cfg, sh, bsh["decode"], "decode",
                             {"tokens": step}, MAX_LEN) == {
        "broadcast": 0, "bytes": 0, "all_sum": 0, "all_sum_bytes": 0}


def test_a_batch_that_does_not_split_raises():
    cfg, model = serve_model("gemma3-1b", 0)
    grid = GridMesh(("data", "model"), (2, 1), rank=0)       # shape only
    psh = param_shardings(model, cfg, grid)
    layout.shard(model, psh)
    sh = {"params": psh, "caches": tree_map(
        lambda _, s: Sharding(grid, s),
        cache_shardings(M.cache_specs(cfg, 4, MAX_LEN), cfg, grid))}
    # specs for an unknown batch split the rows over the data axis
    bsh = {k: Sharding(grid, s)
           for k, s in batch_spec(cfg, grid, kind="prefill").items()}
    with pytest.raises(ValueError, match="does not split"):
        serving.mesh_prefill(sh, bsh)(
            model, {"tokens": torch.zeros(3, PROMPT, dtype=torch.int64)},
            MAX_LEN)
    dsh = {k: Sharding(grid, s)
           for k, s in batch_spec(cfg, grid, kind="decode").items()}
    with pytest.raises(ValueError, match="does not split"):
        serving.mesh_decode(sh, dsh)(
            model, torch.zeros(3, 1, dtype=torch.int64), None, PROMPT)
