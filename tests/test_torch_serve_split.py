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
- a 1x3 grid serving mamba2-370m, whose 8 SSM heads do not divide the
  line: every rank computes the whole SSM layer, as one rank;
- on one rank the SSM layer is bitwise the layer before the split of
  its heads (train and its gradient, prefill, decode);
- `layout.serve_plan`, run shape only on meta tensors, equals each
  call's counted collectives (`core.mesh.tallying`), and on one rank is
  nothing; at full size, mamba2-370m x decode_32k on 16x16, a decode
  step moves no SSM state."""
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
    # 18 positions: a third on each rank; mamba2's 8 SSM heads do not
    # divide the line
    cases = {"gemma3-1b": _case("gemma3-1b", 2)[:4] + (18,),
             "mamba2-370m": _case("mamba2-370m", 2)}
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


def test_a_model_line_the_ssm_heads_do_not_divide_runs_the_layer_whole(
        grid_1x3):
    """8 SSM heads on a line of 3: every rank computes the whole SSM layer,
    as one rank does, and the rules leave both caches whole (neither the
    8 heads nor the 160 conv channels divide 3 ways), so a decode step
    exchanges nothing but the whole logits it already holds: none."""
    _holds_one_rank(grid_1x3, "mamba2-370m", (1, 3))
    for r in (x["mamba2-370m"] for x in grid_1x3[1]):
        assert r["shares"]["ssm_heads"] == [(8, 8, None)], r["shares"]
        assert r["caches"]["ssm"].shape[2:] == (8, 16, 16)
        assert r["caches"]["conv"].shape[2:] == (3, 160)
        assert r["tallies"][1:] == [r["plans"]["decode"]] * STEPS
        assert r["plans"]["decode"]["all_sum"] == 0


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


def _ssm_as_before(layer, xin, mode, cache):
    """`models.ssm.SSM.forward` on one rank as it was before the layer
    learned to split its heads (the seed's code, kept as the reference)."""
    import torch.nn.functional as F
    from repro_torch.models import ssm as S
    from repro_torch.models.common import rmsnorm
    cfg = layer.cfg
    b, t, _ = xin.shape
    d_in, nh, hp, g, st, convdim, _ = S._dims(cfg)
    dt_f = xin.dtype
    zxbcdt = xin @ layer.in_proj.to(dt_f)
    z, xbc_raw, dtp = (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + convdim],
                       zxbcdt[..., d_in + convdim:])
    A = -torch.exp(layer.A_log)
    dt = F.softplus(dtp.float() + layer.dt_bias)
    new_cache = None
    if mode == "decode":
        conv_hist = torch.cat([cache["conv"], xbc_raw], dim=1)
        w, bias = layer.conv_w.to(dt_f), layer.conv_b.to(dt_f)
        k = w.shape[0]
        xbc = F.silu((conv_hist[:, -k:] * w[None]).sum(1) + bias)[:, None]
        x, bmat, cmat = (xbc[..., :d_in], xbc[..., d_in:d_in + g * st],
                         xbc[..., d_in + g * st:])
        xh = x.reshape(b, 1, nh, hp)
        bh = torch.repeat_interleave(bmat.reshape(b, 1, g, st)[:, 0],
                                     nh // g, dim=1)
        ch = torch.repeat_interleave(cmat.reshape(b, 1, g, st)[:, 0],
                                     nh // g, dim=1)
        dt1 = dt[:, 0]
        da = torch.exp(dt1 * A)
        xdt = xh[:, 0] * dt1[..., None].to(dt_f)
        h = (cache["ssm"] * da[..., None, None].to(dt_f)
             + torch.einsum("bhp,bhs->bhps", xdt, bh.to(dt_f)))
        y = torch.einsum("bhs,bhps->bhp", ch.to(dt_f), h)[:, None]
        new_cache = {"conv": conv_hist[:, -(k - 1):], "ssm": h}
    else:
        xbc = S._conv_full(xbc_raw, layer.conv_w.to(dt_f),
                           layer.conv_b.to(dt_f))
        x, bmat, cmat = (xbc[..., :d_in], xbc[..., d_in:d_in + g * st],
                         xbc[..., d_in + g * st:])
        xh = x.reshape(b, t, nh, hp)
        y, h = S._ssd_chunked(xh, bmat.reshape(b, t, g, st),
                              cmat.reshape(b, t, g, st), dt, A, cfg)
        if mode == "prefill":
            new_cache = {"conv": xbc_raw[:, -(layer.conv_w.shape[0] - 1):],
                         "ssm": h}
    y = y + xh * layer.D[None, None, :, None].to(dt_f)
    y = y.reshape(b, t, d_in)
    y = rmsnorm(layer.norm, y * F.silu(z), cfg.norm_eps)
    return y @ layer.out_proj.to(dt_f), new_cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_rank_ssm_layer_is_bitwise_as_before(dtype):
    """On one rank (no model split) the SSM layer -- train, prefill and a
    decode step writing its cache in place -- is bitwise the layer before
    the split of its heads, and so is its gradient."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    from repro_torch.models.common import normal_init
    cfg = get_config("mamba2-370m", smoke=True).replace(dtype=dtype)
    layer = S.SSM(cfg, normal_init(torch.Generator().manual_seed(3), "cpu"))
    with torch.no_grad():
        for p in (layer.D, layer.dt_bias, layer.norm, layer.conv_b):
            p.normal_(generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    xin = torch.randn(2, 21, cfg.d_model, generator=g).to(dtype)
    x1 = xin.clone().requires_grad_(True)
    x2 = xin.clone().requires_grad_(True)
    got, _ = layer(x1, mode="train")
    (gx, *gp) = torch.autograd.grad(got.float().square().sum(),
                                    [x1, *layer.parameters()])
    want, _ = _ssm_as_before(layer, x2, "train", None)
    (wx, *wp) = torch.autograd.grad(want.float().square().sum(),
                                    [x2, *layer.parameters()])
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip([gx, *gp], [wx, *wp]))
    with torch.no_grad():
        got, c1 = layer(xin, mode="prefill")
        want, c2 = _ssm_as_before(layer, xin, "prefill", None)
        assert torch.equal(got, want)
        assert all(torch.equal(c1[k], c2[k]) for k in ("conv", "ssm"))
        step = torch.randn(2, 1, cfg.d_model, generator=g).to(dtype)
        cache = {k: v.clone() for k, v in c1.items()}
        got, out = layer(step, mode="decode", cache=cache)
        want, c2 = _ssm_as_before(layer, step, "decode", c2)
        assert torch.equal(got, want) and out is cache
        assert all(torch.equal(cache[k], c2[k]) for k in ("conv", "ssm"))


def test_serve_plan_of_a_16x16_ssm_decode_step_moves_no_state():
    """`layout.serve_plan` on meta tensors for mamba2-370m x decode_32k on
    16x16 (128 rows, 8 a data rank; 32 SSM heads, 2 a rank): a decode
    step's all_sums are, each of the 48 layers, the conv blocks' exchange
    (8 x 3 x 2304 bf16), the gated norm's sum of squares (8 f32) and
    out_proj's partial output (8 x 1024 bf16), and the whole logits'
    gather (128 x 50280 f32; the vocab does not divide 16): no state,
    which gathered whole would add 8 x 32 x 64 x 128 bf16 a layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import empty_init
    cfg = get_config("mamba2-370m").replace(attn_impl="chunked",
                                            remat=False)
    grid = GridMesh(("data", "model"), (16, 16), rank=0)     # shape only
    model = M.Model(cfg, empty_init("meta"))
    sh = {"params": param_shardings(model, cfg, grid),
          "caches": tree_map(lambda _, s: Sharding(grid, s), cache_shardings(
              M.cache_specs(cfg, 128, 32768), cfg, grid))}
    bsh = {k: Sharding(grid, s) for k, s in batch_spec(
        cfg, grid, kind="decode", batch=128).items()}
    plan = layout.serve_plan(cfg, sh, bsh, "decode", {
        "tokens": torch.empty((128, 1), dtype=torch.int64, device="meta")},
        32768)
    layer = [8 * 3 * 2304 * 2, 8 * 4, 8 * 1024 * 2]
    assert plan["all_sum"] == 48 * len(layer) + 1
    assert plan["all_sum_bytes"] == 48 * sum(layer) + 128 * 50280 * 4
    assert 8 * 32 * 64 * 128 * 2 > sum(layer)
