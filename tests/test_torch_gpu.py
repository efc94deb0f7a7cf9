"""Tests of repro_torch that need a CUDA device (marker ``gpu``).

Each test asks the ``cuda`` fixture, which skips when no card is present
-- decided at run time, so every pytest-xdist worker collects the same
tests.  On a machine with a card (``--noconftest``: the shared
conftest imports jax, which such a machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Kernels against their plain versions at non-tile-multiple shapes: K1, K3,
K8 and K4's R and ls bitwise (NaNs by position), K4's sign exactly (NaN
where the plain version's is), K4's logdet within 1e-6
(f32) / 1e-14 (f64) relative (the card's log against PyTorch's), K2
within its summation-order bound 2*K*eps*(|c|@|r|) + eps*|out| (NaN and
inf where the plain version has them; a 32-row call bitwise equal to the
same rows of the full call, as the mesh lookahead needs), K6 and K7
within twice the rounding bound of one evaluation (`ref.cheb_step_bound`,
`ref.cg_step_bound`), K5 within `ref.matvec_bound`.  The estimators on
the card against the same calls on the CPU, with the same probes and
bounds, and their launch counts; the gradients of the exact plans
(inv(A)^T, no launch in the backward) and of the estimators (K7 never,
K8 on the lattice once per CG iteration plus one); the mesh routes on
one rank under NCCL.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.engine import EngineConfig, build_serial, stage_schedule
from repro_torch import estimators as est
from repro_torch.kernels import condense_step, fused_est, fused_step, ops, ref
from repro_torch.kernels import panel_factor as k4
from repro_torch.kernels import panel_update as k2
from repro_torch.kernels import stencil_mv as k8

pytestmark = pytest.mark.gpu

VARIANTS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
            (torch.float32, torch.bfloat16), (torch.float64, torch.bfloat16)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, *shape, dtype, device):
    return torch.randn(*shape, generator=gen, dtype=torch.float64).to(
        device=device, dtype=dtype)


# K1's paths: one row (the mesh lookahead's calls: its one-row instance);
# widths just under and just over a block's span (256 threads of one
# 16-byte vector: 1024 f32 or 512 f64 columns); rows 1.. of a matrix of
# odd width, whose rows are not 16-byte aligned (a third entry drops that
# many rows); 20001 rows of one block's width (2501 row blocks, more than
# the card holds at once)
@pytest.mark.parametrize("shape", [(1, 1), (7, 129), (129, 7), (255, 383),
                                   (33, 257), (1, 8192), (5, 511), (5, 513),
                                   (5, 1023), (5, 1025), (40, 1001, 1),
                                   (40, 8191, 1), (20001, 100)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_rank1_and_fused_step_bitwise(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(0)
    m, n, *skip = shape
    a = _randn(gen, m, n, dtype=dt, device=cuda)[sum(skip):]
    m -= sum(skip)
    pc = _randn(gen, m, dtype=op, device=cuda)
    pr = _randn(gen, n, dtype=op, device=cuda)
    assert torch.equal(condense_step.rank1_update(a, pc, pr),
                       ref.rank1_update_ref(a, pc, pr))
    l, last = torch.tensor([n // 2], device=cuda), n - 1
    cl, clast = a[:, n // 2].contiguous(), a[:, last].contiguous()
    assert torch.equal(fused_step.fused_step(a, l, last, pc, pr, cl, clast),
                       ref.fused_step_ref(a, l, last, pc, pr, cl, clast))


@pytest.mark.parametrize("where", ["a", "pc", "pr", "all"])
@pytest.mark.parametrize("n", [257, 1024])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_rank1_update_special_values(cuda, where, n, dt, op):
    """-0, +-inf and NaN in a, pc or pr: K1 equal to the plain version bit
    for bit (NaNs by position), on the vector path (n = 1024) and the
    scalar one (n = 257); with all of them, -0 - (+0) stays -0, -0 - (-0)
    is +0 and inf - inf is NaN."""
    gen = torch.Generator().manual_seed(2)
    m = 9
    a = _randn(gen, m, n, dtype=dt, device=cuda)
    pc = _randn(gen, m, dtype=op, device=cuda)
    pr = _randn(gen, n, dtype=op, device=cuda)
    if where in ("a", "all"):
        a[0, :4] = -0.0
        a[1, 1], a[1, 2], a[2, 5] = float("inf"), float("-inf"), float("nan")
    if where in ("pc", "all"):
        pc[0], pc[3], pc[4] = -0.0, float("inf"), float("nan")
    if where in ("pr", "all"):
        pr[0], pr[1], pr[2], pr[6] = 0.0, -0.0, float("-inf"), float("nan")
    got = condense_step.rank1_update(a, pc, pr)
    want = ref.rank1_update_ref(a, pc, pr)
    assert _same_bits(got, want) and got.isnan().any()


@pytest.mark.parametrize("shape", [(7, 129, 3), (65, 190, 33),
                                   (129, 257, 100), (256, 256, 32)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_panel_update_within_bound(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(1)
    m, n, k = shape
    a = _randn(gen, m, n, dtype=dt, device=cuda)
    c = _randn(gen, m, k, dtype=op, device=cuda)
    r = _randn(gen, k, n, dtype=op, device=cuda)
    got, want = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
    tol = ref.panel_update_bound(a, c, r, want)
    assert bool(((got - want).abs() <= tol).all())


def _k2_operands(gen, m, n, k, dt, op, device):
    return (_randn(gen, m, n, dtype=dt, device=device),
            _randn(gen, m, k, dtype=op, device=device),
            _randn(gen, k, n, dtype=op, device=device))


# row blocks at a tile's start, inside a tile, and at the matrix's end;
# n a multiple of 16 bytes (vector epilogue) and odd (element copies);
# 2048 rows span more tiles than the card holds blocks (in f32 each
# block walks several)
@pytest.mark.parametrize("row0", [0, 32, 37, 2016])
@pytest.mark.parametrize("n", [2080, 2047])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_panel_update_row_block_bitwise(cuda, row0, n, dt, op):
    """The mesh lookahead's invariant: K2 on 32 rows equals the same rows
    of the full call bit for bit (one summation order, whatever the call's
    shape or a row's place in a tile), and a repeated call is bitwise
    equal."""
    gen = torch.Generator().manual_seed(4)
    a, c, r = _k2_operands(gen, 2048, n, 32, dt, op, cuda)
    full = k2.panel_update(a, c, r)
    rows = slice(row0, row0 + 32)
    assert torch.equal(k2.panel_update(a[rows], c[rows].contiguous(), r),
                       full[rows])
    assert torch.equal(k2.panel_update(a, c, r), full)


@pytest.mark.parametrize("where", ["a_nan", "a_inf", "c_nan", "c_neg_inf",
                                   "r_nan", "r_inf", "r_inf_zero_c_row"])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_panel_update_special_values(cuda, where, dt, op):
    """NaN and inf in a, c or r propagate as in the plain version: the
    same NaN positions, the same infinities with their signs, and the
    finite entries within the summation-order bound."""
    gen = torch.Generator().manual_seed(5)
    a, c, r = _k2_operands(gen, 300, 515, 32, dt, op, cuda)
    special = {"a_nan": (a, (7, 9), float("nan")),
               "a_inf": (a, (7, 9), float("inf")),
               "c_nan": (c, (11, 3), float("nan")),
               "c_neg_inf": (c, (11, 3), -float("inf")),
               "r_nan": (r, (5, 100), float("nan")),
               "r_inf": (r, (5, 100), float("inf")),
               "r_inf_zero_c_row": (r, (5, 100), float("inf"))}
    t, at, value = special[where]
    t[at] = value
    if where == "r_inf_zero_c_row":
        c[20] = 0.0     # a masked row: 0 * inf is NaN in both
    got, plain = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
    assert torch.isnan(got).any() or torch.isinf(got).any()
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    inf = torch.isinf(plain)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], plain[inf])
    fin = torch.isfinite(plain)
    tol = ref.panel_update_bound(a, c, r, plain)
    assert bool(((got - plain).abs()[fin] <= tol[fin]).all())


# widths of the staged route's stages at N = 8192 (stage_schedule(8192,
# 0.75, 64)), from the last stage up
@pytest.mark.parametrize("width", [64, 462, 1944, 4608])
@pytest.mark.parametrize("k", [7, 32, 48])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_panel_update_staged_widths(cuda, width, k, dt, op):
    gen = torch.Generator().manual_seed(6)
    a, c, r = _k2_operands(gen, width, width, k, dt, op, cuda)
    got, plain = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
    tol = ref.panel_update_bound(a, c, r, plain)
    assert bool(((got - plain).abs() <= tol).all())


def _same_bits(a, b) -> bool:
    """Equal bit for bit (-0 differs from +0), NaNs by position only."""
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints))


def _same_value(x: float, y: float, rtol: float) -> bool:
    if x != x or y != y:
        return x != x and y != y
    return x == y or abs(x - y) <= rtol * abs(y)


# (K, N, m0): odd widths; widths that are no multiple of the cluster size
# (4607, 8191, 1000); narrower than 16 blocks of MIN_COLS (100, 300, 1000);
# K = 1 and 64; the global-memory branch (28673 f32, 14337 f64 and the
# f64 (700, 777)); a tall panel (1024, 1500)
PANEL_SHAPES = [(3, 33, 33), (5, 129, 100), (16, 200, 170), (32, 1000, 640),
                (32, 100, 90), (32, 300, 300), (32, 4607, 4607),
                (32, 8191, 8000), (32, 8192, 8192), (1, 64, 64),
                (1, 8191, 5000), (64, 8192, 8192), (64, 4608, 4000),
                (32, 28673, 28673), (32, 14337, 14000), (700, 777, 777),
                (1024, 1500, 1400)]


@pytest.mark.parametrize("k,n,m0", PANEL_SHAPES)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_panel_factor_bitwise(cuda, k, n, m0, dt):
    gen = torch.Generator().manual_seed(2)
    panel = _randn(gen, k, n, dtype=dt, device=cuda)
    R, ls, s, ld = k4.panel_factor(panel, m0, 3)
    R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0, 3)
    assert _same_bits(R, R0) and torch.equal(ls, ls0)
    assert s.item() == s0.item()
    rtol = 1e-6 if dt == torch.float32 else 1e-14
    assert abs(ld.item() - ld0.item()) <= rtol * abs(ld0.item())


@pytest.mark.parametrize("kind", ["nan", "nan_dead", "inf", "neg_inf",
                                  "zero_row", "zero_pivot_column"])
@pytest.mark.parametrize("k,n,m0", [(32, 8192, 8000), (32, 300, 260),
                                    (32, 28673, 28000)])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_panel_factor_special_values(cuda, k, n, m0, kind, dt):
    """NaN, +-inf and zero pivots: R and ls bit for bit, the sign exactly
    (NaN for a live NaN, as ref.nan_sign), log|det| alike."""
    gen = torch.Generator().manual_seed(3)
    panel = _randn(gen, k, n, dtype=dt, device=cuda)
    if kind == "nan":
        panel[2, 100] = float("nan")
    elif kind == "nan_dead":
        panel[2, n - 1] = float("nan")
    elif kind == "inf":
        panel[4, 7] = float("inf")
    elif kind == "neg_inf":
        panel[0, 50] = -float("inf")
    elif kind == "zero_row":
        panel[3] = 0.0
    else:
        panel[:, 11] = 0.0
        panel[5] = 0.0
    R, ls, s, ld = k4.panel_factor(panel, m0, 1)
    R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0, 1)
    assert _same_bits(R, R0) and torch.equal(ls, ls0)
    assert _same_value(s.item(), s0.item(), 0.0), (s.item(), s0.item())
    rtol = 1e-6 if dt == torch.float32 else 1e-14
    assert _same_value(ld.item(), ld0.item(), rtol), (ld.item(), ld0.item())
    if kind == "nan":
        assert torch.isnan(s)


def test_panel_factor_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses raises from the wrapper: shared memory
    above one block's limit, or a cluster above 16 blocks (the C entry
    refuses that cut), and nothing is counted."""
    panel = torch.randn(32, 8192, device=cuda)
    too_much = k4.PanelFactorPlan(4, 2048, True,
                                  k4.smem_bytes(32, 2048, 4, True))
    too_wide = k4.PanelFactorPlan(32, 256, True,
                                  k4.smem_bytes(32, 256, 4, True))
    for bad in (too_much, too_wide):
        monkeypatch.setattr(k4, "plan", lambda k, n, dtype, p=bad: p)
        before = k4.launches
        with pytest.raises(RuntimeError, match="panel_factor"):
            k4.panel_factor(panel, 8192)
        assert k4.launches == before
    monkeypatch.undo()
    R, ls, _, _ = k4.panel_factor(panel, 8192)
    R0, ls0, _, _ = ref.panel_factor_ref(panel, 8192)
    assert _same_bits(R, R0) and torch.equal(ls, ls0)


@pytest.mark.parametrize("update", ["rank1", "panel"])
def test_nan_entry_on_the_card(cuda, update):
    """A NaN entry gives sign NaN and log|det| NaN on the card, as on the
    CPU and in the JAX package."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((256, 256)))
    a[5, 7] = float("nan")
    res = repro_torch.plan(a.float().to(cuda), method="exact", update=update,
                           k=32)()
    assert torch.isnan(res.sign) and torch.isnan(res.logabsdet)


def test_wrappers_check_their_operands(cuda):
    a = torch.zeros((4, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        condense_step.rank1_update(a.t(), a[0].clone(), a[1].clone())
    with pytest.raises(TypeError, match="operands"):
        condense_step.rank1_update(a, a[0].double(), a[1].double())
    with pytest.raises(ValueError, match="m0"):
        k4.panel_factor(a[:2].contiguous(), 9)


@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_engine_on_the_card(cuda, update, dt):
    """The card agrees with the CPU run of the same plan, fused equals
    unfused bit for bit, and the launch counts show the kernels ran: K1
    or K3 for the rank-1 steps, K2 and K4 once per panel."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((200, 200))
    a = torch.from_numpy(x @ x.T / 200 + 2 * np.eye(200)).to(dt)
    a[7] = -a[7]
    kw = dict(schedule="staged", update=update, panel_k=16, min_size=32)
    s_cpu, ld_cpu = build_serial(EngineConfig(**kw))(a)
    out = {}
    for fused in (False, True):
        ops.reset_launch_counts()
        out[fused] = build_serial(EngineConfig(fused=fused, **kw))(a.to(cuda))
        counts = ops.launch_counts()
        assert counts["fused_step" if fused else "rank1_update"] > 0
        assert counts["rank1_update" if fused else "fused_step"] == 0
        if update == "panel":
            assert counts["panel_update"] == counts["panel_factor"] > 0
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    assert out[False][0].item() == s_cpu.item() == -1.0
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    assert abs(out[False][1].item() - ld_cpu.item()) <= rtol * abs(
        ld_cpu.item())


def test_plan_defaults_to_the_card(cuda):
    """device=None runs on the card; a CPU input is moved there and left
    unmodified."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((96, 96)))
    before = a.clone()
    ops.reset_launch_counts()
    res = repro_torch.plan(a, method="exact")()
    assert res.sign.device.type == "cuda"
    assert ops.launch_counts()["rank1_update"] == sum(
        steps for _, steps in stage_schedule(96, 0.75, 64))
    assert torch.equal(a, before)
    s_np, ld_np = np.linalg.slogdet(a.numpy())
    assert res.sign.item() == s_np
    assert abs(res.logabsdet.item() - ld_np) <= 1e-10 * abs(ld_np)


EST_DTYPES = [torch.float32, torch.float64]
# K6 at k = 1 (one warp a row), then for k = 5, 16, 33, 64 and 65 with
# the reduction axis in one range (n at most one 32-column f64 stage, or
# more 128-row blocks than 132 SMs take two of: (4300, 200)) and split
# (`matvec.plan` for (n, n, k) on a 132-SM H100); no n a multiple of 128
EST_SHAPES = [(1, 1), (1000, 1), (30, 5), (1001, 5), (31, 16), (1001, 16),
              (29, 33), (257, 33), (31, 64), (1000, 64), (27, 65),
              (1000, 65), (130, 7), (1000, 32), (4300, 200)]


@pytest.mark.parametrize("n,k", EST_SHAPES)
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_cheb_step_within_bound(cuda, n, k, dt):
    gen = torch.Generator().manual_seed(3)
    a, w, wp, v = (_randn(gen, *s, dtype=dt, device=cuda)
                   for s in ((n, n), (n, k), (n, k), (n, k)))
    c = torch.tensor([1.7], dtype=dt, device=cuda)
    wd = torch.tensor([3.1], dtype=dt, device=cuda)
    wn, d = fused_est.cheb_step(a, w, wp, v, c, wd)
    wn0, d0 = ref.cheb_step_ref(a, w, wp, v, c, wd)
    tol_w, tol_d = ref.cheb_step_bound(a, w, wp, v, c, wd)
    assert bool(((wn - wn0).abs() <= 2 * tol_w).all())
    assert bool(((d - d0).abs() <= 2 * tol_d).all())
    wn2, d2 = fused_est.cheb_step(a, w, wp, v, c, wd)
    assert torch.equal(wn, wn2) and torch.equal(d, d2)   # no atomics


@pytest.mark.parametrize("n,k", EST_SHAPES)
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_cg_step_within_bound(cuda, n, k, dt):
    gen = torch.Generator().manual_seed(4)
    a, p, x, r = (_randn(gen, *s, dtype=dt, device=cuda)
                  for s in ((n, n), (n, k), (n, k), (n, k)))
    rz = _randn(gen, k, dtype=dt, device=cuda)
    p[:, 0] = 0                          # a converged column: den = 0
    x1, r1 = fused_est.cg_step(a, p, x, r, rz)
    x0, r0 = ref.cg_step_ref(a, p, x, r, rz)
    tol_x, tol_r = ref.cg_step_bound(a, p, x, r, rz)
    assert bool(((x1 - x0).abs() <= 2 * tol_x).all())
    assert bool(((r1 - r0).abs() <= 2 * tol_r).all())
    assert torch.equal(x1[:, 0], x[:, 0]) and torch.equal(r1[:, 0], r[:, 0])
    x2, r2 = fused_est.cg_step(a, p, x, r, rz)
    assert torch.equal(x1, x2) and torch.equal(r1, r2)


# K7 on rows 1.. of an (n + 1, n) matrix: rows 4 or 8 bytes past a
# 16-byte boundary (element copies of A), or on one with n not a multiple
# of a stage (16-byte copies); the reduction axis split ((1025, 32),
# (1028, 32)) or whole ((4301, 200)), and one warp a row ((1025, 3))
@pytest.mark.parametrize("n,k", [(1025, 32), (1028, 32), (1025, 3),
                                 (4301, 200)])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_cg_step_on_unaligned_rows(cuda, n, k, dt):
    gen = torch.Generator().manual_seed(12)
    a = _randn(gen, n + 1, n, dtype=dt, device=cuda)[1:]
    p, x, r = (_randn(gen, n, k, dtype=dt, device=cuda) for _ in range(3))
    rz = _randn(gen, k, dtype=dt, device=cuda)
    p[:, 0] = 0                          # a converged column: den = 0
    x1, r1 = fused_est.cg_step(a, p, x, r, rz)
    x0, r0 = ref.cg_step_ref(a, p, x, r, rz)
    tol_x, tol_r = ref.cg_step_bound(a, p, x, r, rz)
    assert bool(((x1 - x0).abs() <= 2 * tol_x).all())
    assert bool(((r1 - r0).abs() <= 2 * tol_r).all())
    assert torch.equal(x1[:, 0], x[:, 0]) and torch.equal(r1[:, 0], r[:, 0])
    x2, r2 = fused_est.cg_step(a, p, x, r, rz)
    assert torch.equal(x1, x2) and torch.equal(r1, r2)


@pytest.mark.parametrize("n,offsets,k", [
    (1, (0,), 3), (11, (-1, 0, 1), 4), (37, (-5, 0, 5), 1),
    (300, (-3, -1, 0, 2, 7), 5), (1024, (-32, -1, 0, 1, 32), 32)])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_stencil_mv_bitwise(cuda, n, offsets, k, dt):
    gen = torch.Generator().manual_seed(5)
    bands = _randn(gen, len(offsets), n, dtype=dt, device=cuda)
    x = _randn(gen, n, k, dtype=dt, device=cuda)
    assert torch.equal(k8.stencil_mv(bands, x, offsets),
                       ref.stencil_mv_ref(bands, x, offsets=offsets))
    v = x[:, 0].contiguous()                          # the vector form
    assert torch.equal(k8.stencil_mv(bands, v, offsets),
                       ref.stencil_mv_ref(bands, v, offsets=offsets))
    xs = _randn(gen, n * k + 1, dtype=dt, device=cuda)[1:].view(n, k)
    assert torch.equal(k8.stencil_mv(bands, xs, offsets),   # not 16-B aligned
                       ref.stencil_mv_ref(bands, xs, offsets=offsets))


def test_estimator_wrappers_check_their_operands(cuda):
    a = torch.zeros((8, 8), device=cuda)
    w = torch.zeros((8, 2), device=cuda)
    one = torch.ones(1, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        fused_est.cheb_step(a, w, w, w.double(), one, one)
    with pytest.raises(ValueError, match="slabs"):
        fused_est.cg_step(a, w, w, w[:4].contiguous(),
                          torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="offsets"):
        k8.stencil_mv(a[:2].contiguous(), w, (0, 8))
    with pytest.raises(ValueError, match="contiguous"):
        k8.stencil_mv(a[:1].contiguous(), w.t(), (0,))


def _lattice(side, dt, device):
    n = side * side
    i = torch.arange(n, device=device)
    bands = torch.full((5, n), -1.0, dtype=dt, device=device)
    bands[2] = 4.1
    bands[1] = torch.where(i % side == 0, 0.0, -1.0)
    bands[3] = torch.where(i % side == side - 1, 0.0, -1.0)
    return est.StencilOperator((-side, -1, 0, 1, side), bands)


def _dense(n, dt):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, n))
    return torch.from_numpy(x @ x.T / n + 2 * np.eye(n)).to(dt)


@pytest.mark.parametrize("kind", ["dense", "lattice"])
@pytest.mark.parametrize("method", ["chebyshev", "slq"])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_estimator_plans_on_the_card(cuda, kind, method, dt):
    """The card agrees with the CPU with the same probes and bounds; the
    launch counts show which kernel carried each route."""
    x = _dense(200, dt) if kind == "dense" else _lattice(16, dt, "cpu")
    probes = est.make_probes(torch.Generator().manual_seed(8), 200 if
                             kind == "dense" else 256, 16, dtype=dt)
    kw = (dict(degree=24, num_probes=16, lmin=0.05, lmax=9.0)
          if method == "chebyshev" else dict(num_steps=12, num_probes=16))
    cpu = repro_torch.plan(x, method=method, device="cpu", **kw)(
        probes=probes)
    ops.reset_launch_counts()
    card = repro_torch.plan(x, method=method, **kw)(probes=probes)
    counts = ops.launch_counts()
    assert card.logabsdet.device.type == "cuda"
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    assert abs(card.logabsdet.item() - cpu.logabsdet.item()) <= rtol * abs(
        cpu.logabsdet.item())
    want = dict.fromkeys(counts, 0)
    if kind == "lattice":
        want["stencil_mv"] = kw["degree"] if method == "chebyshev" else 12
    elif method == "chebyshev":
        want["cheb_step"] = kw["degree"] - 1
    assert counts == want


@pytest.mark.parametrize("kw", [dict(method="ge"),
                                dict(method="exact", update="rank1"),
                                dict(method="exact", update="panel", k=8),
                                dict(method="exact", update="rank1",
                                     fused=True)],
                         ids=["ge", "rank1", "panel", "fused"])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_exact_grad_on_the_card(cuda, kw, dt):
    """The gradient of an exact plan on a CUDA tensor is inv(A)^T (before
    the VJP, the kernels' outputs cut the graph after their first
    launch); the forward launches the route's kernels, the backward
    none, and value_and_grad gives the same bits."""
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((150, 150))
                         * 0.3 + 2.0 * np.eye(150))
    x = a.to(device=cuda, dtype=dt).requires_grad_()
    p = repro_torch.plan(x.detach(), **kw)
    ops.reset_launch_counts()
    ld = p.logdet(x)
    forward = ops.launch_counts()
    ops.reset_launch_counts()
    ld.backward()
    assert sum(ops.launch_counts().values()) == 0
    assert forward["rank1_update"] + forward["fused_step"] > 0
    rtol = 1e-4 if dt == torch.float32 else 1e-10
    want = torch.linalg.inv(a).T
    assert (x.grad.cpu().double() - want).abs().max() <= rtol * want.abs().max()
    res, g = p.value_and_grad()
    assert torch.equal(g, x.grad) and torch.equal(res.logabsdet, ld.detach())


_RANK2 = [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]]


@pytest.mark.parametrize("case", ["rank2", "zero", "stack"])
@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_exact_grad_on_singular_input_on_the_card(cuda, case, update, dt):
    """A singular matrix: value_and_grad and backward raise nothing; the
    singular matrix's gradient is non-finite, and a stack's regular
    matrix (I) gets its exact gradient I (the singular entries depend on
    rounding and are not compared)."""
    r2 = torch.tensor(_RANK2, dtype=dt)
    a = {"rank2": r2, "zero": torch.zeros(3, 3, dtype=dt),
         "stack": torch.stack([torch.eye(3, dtype=dt), r2])}[case].to(cuda)
    kw = dict(method="exact", update=update, k=2, device=cuda)
    _, g = repro_torch.plan(a, **kw).value_and_grad()
    x = a.clone().requires_grad_()
    repro_torch.plan(a, **kw).logdet(x).sum().backward()
    for grad in (g, x.grad):
        finite = torch.isfinite(grad).reshape(-1, 9).all(dim=1).tolist()
        assert finite == ([True, False] if case == "stack" else [False])
        if case == "stack":
            assert torch.equal(grad[0].cpu(), torch.eye(3, dtype=dt))


@pytest.mark.parametrize("kind", ["dense", "lattice"])
@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_estimator_grad_on_the_card(cuda, kind, method):
    """The estimator backward on the card: the transposed CG takes rmm,
    so K7 never launches; on the lattice K8 launches once per CG
    iteration plus once for the bilinear apply.  The gradient equals the
    CPU's with the same probes and bounds (f64)."""
    dt = torch.float64
    x = _dense(200, dt) if kind == "dense" else _lattice(16, dt, "cpu")
    n = 200 if kind == "dense" else 256
    probes = est.make_probes(torch.Generator().manual_seed(8), n, 16,
                             dtype=dt)
    kw = (dict(degree=24, num_probes=16, lmin=0.05, lmax=9.0)
          if method == "chebyshev" else dict(num_steps=12, num_probes=16))

    def grad(device):
        if kind == "dense":
            leaf = x.detach().to(device).requires_grad_()
            arg = leaf
        else:
            leaf = x.bands.detach().to(device).requires_grad_()
            arg = est.StencilOperator(x.offsets, leaf)
        ld = repro_torch.plan(arg, method=method, device=device, **kw) \
            .logdet(probes=probes)
        ops.reset_launch_counts()
        ld.backward()
        return leaf.grad, ops.launch_counts()

    cpu, _ = grad("cpu")
    card, counts = grad(cuda)
    op = est.as_operator(x)
    _, cg = est.hutchinson_pullback(op, est.operator_grad_info(op)
                                    .params(op), probes, 1.0)
    want = dict.fromkeys(counts, 0)
    if kind == "lattice":
        want["stencil_mv"] = cg.iters + 1
    assert counts == want
    assert (card.cpu() - cpu).abs().max() <= 1e-8 * cpu.abs().max()


@pytest.mark.parametrize("kind", ["dense", "lattice"])
def test_cg_solve_on_the_card(cuda, kind):
    dt = torch.float64
    a = _dense(150, dt) if kind == "dense" else _lattice(12, dt, "cpu")
    n = a.shape[0]
    b = torch.from_numpy(np.random.default_rng(9).standard_normal((n, 4)))
    ops.reset_launch_counts()
    res = est.cg_solve(a.to(cuda), b, tol=1e-10)
    counts = ops.launch_counts()
    assert res.x.device.type == "cuda" and bool(res.converged)
    name = "cg_step" if kind == "dense" else "stencil_mv"
    assert counts[name] == res.iters > 0
    cpu = est.cg_solve(a, b, tol=1e-10, device="cpu")
    assert torch.allclose(res.x.cpu(), cpu.x, rtol=1e-8, atol=1e-10)
    if kind == "dense":             # a strided view, and the default device
        wide = torch.zeros((n, 2 * n), dtype=dt)
        wide[:, :n] = a
        view = est.cg_solve(wide.to(cuda)[:, :n], b, tol=1e-10)
        assert torch.equal(view.x, res.x)


def test_cg_step_splits_wide_slabs(cuda):
    """More columns than K7 keeps alphas for: one call per column block,
    each counted, the same result as the plain version."""
    n, k = 64, fused_est.MAX_CG_COLUMNS + 5
    gen = torch.Generator().manual_seed(6)
    a, p, x, r = (_randn(gen, *s, dtype=torch.float32, device=cuda)
                  for s in ((n, n), (n, k), (n, k), (n, k)))
    rz = _randn(gen, k, dtype=torch.float32, device=cuda)
    ops.reset_launch_counts()
    x1, r1 = fused_est.cg_step(a, p, x, r, rz)
    assert ops.launch_counts()["cg_step"] == 2
    x0, r0 = ref.cg_step_ref(a, p, x, r, rz)
    tol_x, tol_r = ref.cg_step_bound(a, p, x, r, rz)
    assert bool(((x1 - x0).abs() <= 2 * tol_x).all())
    assert bool(((r1 - r0).abs() <= 2 * tol_r).all())


@pytest.mark.parametrize("shape", [(1, 1, 1), (37, 1001, 1), (300, 512, 3),
                                   (129, 257, 33), (64, 128, 64),
                                   (100, 96, None),
                                   # the tile's column widths 16 / 32 / 64 and
                                   # two column blocks (k = 65)
                                   (129, 257, 5), (64, 128, 8), (100, 300, 65),
                                   # split-K, a ragged block, and a row block
                                   # of a (257, 1025) matrix that starts 4 or 8
                                   # bytes past a 16-byte boundary
                                   (256, 16384, 32), (129, 1001, 32),
                                   (257, 1025, 32, 1)])
@pytest.mark.parametrize("dt", EST_DTYPES)
def test_matvec_within_bound(cuda, shape, dt):
    """K5 and its plain version each within `ref.matvec_bound` of the f64
    product (twice it for f64 input, itself one evaluation); the GEMV
    path (k <= 4, aligned or not), the tile path at every column width,
    split or not, on 16-byte-aligned rows or not, and a vector x; one
    counted launch per call, a repeated call bitwise equal."""
    from repro_torch.kernels import matvec as k5
    gen = torch.Generator().manual_seed(10)
    m, n, k, *skip = shape
    a = _randn(gen, m, n, dtype=dt, device=cuda)[sum(skip):]
    x = _randn(gen, *((n,) if k is None else (n, k)), dtype=dt, device=cuda)
    exact = a.double() @ x.double()
    bound = (2.0 if dt == torch.float64 else 1.0) * ref.matvec_bound(a, x)
    ops.reset_launch_counts()
    got = ops.matvec(a, x)
    assert ops.launch_counts()["matvec"] == 1 and got.shape == exact.shape
    for out in (got, ref.matvec_ref(a, x)):
        assert bool(((out.double() - exact).abs() <= bound.double()).all())
    assert torch.equal(k5.matvec(a, x), got)      # repeatable


def test_mesh_routes_on_the_card(cuda):
    """One rank under NCCL: the four mesh routes agree with the CPU's
    mesh routes, lookahead equals plain bit for bit, and the launch
    counts are the schedule's; a sharded Chebyshev launches K5 for every
    product (66 for the bounds, then the degree)."""
    import test_torch_ranks as ranks
    from repro_torch.core.mesh import run_ranks
    n, k, degree = 200, 16, 12
    rng = np.random.default_rng(11)
    a = rng.standard_normal((n, n)) + n ** 0.5 * np.eye(n)
    card = run_ranks(ranks.card_routes, 1, backend="nccl", device="cuda",
                     timeout=600, args=(a, k, degree))[0]
    cpu = run_ranks(ranks.exact_routes, 1, backend="gloo", device="cpu",
                    timeout=600, args=({"a": a},))[0]
    s_np, ld_np = np.linalg.slogdet(a)
    for update in ("rank1", "panel"):
        (s, ld), counts = card[f"{update}|0"]
        assert card[f"{update}|1"][0] == (s, ld)
        assert s == s_np and abs(ld - ld_np) <= 1e-10 * abs(ld_np)
        assert abs(ld - cpu[f"a|float64|{update}|0"][1]) <= 1e-10 * abs(ld)
        for la in (0, 1):
            assert card[f"{update}|{la}"][1] == ranks.mesh_launches(
                n, 1, 0, k, update, bool(la))
    value, counts = card["chebyshev"]
    assert np.isfinite(value) and counts["matvec"] == 66 + degree


def test_auto_route_on_the_card(cuda):
    """``method="auto"`` on the card runs the route `select_route` names,
    at its panel width, through that route's kernels, and equals the same
    plan on the CPU."""
    from repro_torch.core import select_route
    a = np.random.default_rng(12).standard_normal((300, 300))
    method, route = select_route(torch.from_numpy(a), rtol=1e-6)
    p = repro_torch.plan(a, rtol=1e-6)
    assert p.device.type == "cuda" and p.method == method == "exact"
    assert (p.config.schedule, p.config.update, p.config.k) == (
        route.schedule, route.update, route.panel_k)
    ops.reset_launch_counts()
    s, ld = (float(v) for v in p())
    counts = ops.launch_counts()
    cs, cl = (float(v) for v in repro_torch.plan(a, rtol=1e-6,
                                                 device="cpu")())
    s_np, ld_np = np.linalg.slogdet(a)
    assert s == cs == s_np
    assert abs(ld - ld_np) <= 1e-10 * abs(ld_np)
    assert abs(ld - cl) <= 1e-10 * abs(cl)
    kernel = "panel_update" if route.update == "panel" else "rank1_update"
    assert counts[kernel] > 0


@pytest.mark.parametrize("dt,rtol", [(torch.float32, 1e-4),
                                     (torch.float64, 1e-10)])
def test_ge_on_the_card(cuda, dt, rtol):
    """Serial GE on the card: one K1 launch a step below the last, the
    CPU's sign and log|det| within rtol."""
    a = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (257, 257))).to(dt)
    ops.reset_launch_counts()
    s, ld = (float(v) for v in repro_torch.plan(a, method="ge")())
    assert ops.launch_counts()["rank1_update"] == 256
    cs, cl = (float(v) for v in repro_torch.plan(a, method="ge",
                                                 device="cpu")())
    assert s == cs and abs(ld - cl) <= rtol * abs(cl)


def test_pge_and_plu_at_one_rank_on_the_card(cuda):
    """One rank under NCCL: pge and plu (nb = 1, 8) give numpy's sign and
    log|det|, K1 / K2 launches and collectives by their formulas."""
    import test_torch_ranks as ranks
    from repro_torch.core.mesh import run_ranks
    n = 200
    a = np.random.default_rng(14).standard_normal((n, n))
    card = run_ranks(ranks.card_baselines, 1, backend="nccl", device="cuda",
                     timeout=600, args=(a, (1, 8)))[0]
    s_np, ld_np = np.linalg.slogdet(a)
    for name, ((s, ld), counts, colls) in card.items():
        assert s == s_np and abs(ld - ld_np) <= 1e-10 * abs(ld_np), name
        nb = 1 if name == "pge" else int(name[3:])
        panels = 0 if name == "pge" else (n - 1) // nb
        assert counts["rank1_update"] == n - 1 - panels, name
        assert counts["panel_update"] == panels, name
        assert colls == {"broadcast": n, "all_sum": 2 * n + (
            0 if name == "pge" else n // nb)}, name


# ------------------------------------------------------------------ stacks
# K1-K4 on (B, ...) stacks: one launch (their batch grids), bitwise (K2:
# within its bound) against the batched plain version, and matrix b bit
# for bit the single-matrix launch on it; then the exact routes, the
# estimators on a BatchedOperator and the gradients of a stack on the card


@pytest.mark.parametrize("shape", [(1, 7, 129), (3, 64, 64), (5, 33, 257),
                                   (4, 129, 7), (70, 60, 60), (2, 1, 8192)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_stack_rank1_and_fused_step_bitwise(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(4)
    b, m, n = shape
    a = _randn(gen, b, m, n, dtype=dt, device=cuda)
    pc = _randn(gen, b, m, dtype=op, device=cuda)
    pr = _randn(gen, b, n, dtype=op, device=cuda)
    l = torch.randint(0, n, (b,), generator=gen).to(cuda)
    last = n - 1
    cl = a.gather(2, l[:, None, None].expand(b, m, 1))[..., 0].contiguous()
    clast = a[:, :, last].contiguous()
    before = condense_step.launches, fused_step.launches
    got = condense_step.rank1_update(a, pc, pr)
    got3 = fused_step.fused_step(a, l, last, pc, pr, cl, clast)
    assert (condense_step.launches, fused_step.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got, ref.rank1_update_ref(a, pc, pr))
    assert torch.equal(got3, ref.fused_step_ref(a, l, last, pc, pr, cl,
                                                clast))
    for i in range(b):
        assert torch.equal(got[i], condense_step.rank1_update(a[i], pc[i],
                                                              pr[i]))
        assert torch.equal(got3[i], fused_step.fused_step(
            a[i], l[i:i + 1], last, pc[i], pr[i], cl[i], clast[i]))


@pytest.mark.parametrize("rows", [1, 5, 64])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_stack_rank1_update_takes_a_batch_stride(cuda, rows, dt):
    """Gaussian elimination's rows below the pivot: a strided view of the
    stack, each matrix's rows contiguous."""
    gen = torch.Generator().manual_seed(5)
    buf = _randn(gen, 3, rows + 1, 130, dtype=dt, device=cuda)
    a = buf[:, 1:]
    pc = _randn(gen, 3, rows, dtype=dt, device=cuda)
    pr = _randn(gen, 3, 130, dtype=dt, device=cuda)
    got = condense_step.rank1_update(a, pc, pr)
    assert got.is_contiguous()
    assert torch.equal(got, ref.rank1_update_ref(a, pc, pr))


@pytest.mark.parametrize("shape", [(1, 7, 129, 3), (3, 65, 190, 33),
                                   (5, 64, 64, 8), (2, 129, 257, 64),
                                   (40, 64, 64, 8)])
@pytest.mark.parametrize("dt,op", VARIANTS)
def test_stack_panel_update_within_bound(cuda, shape, dt, op):
    gen = torch.Generator().manual_seed(6)
    b, m, n, k = shape
    a = _randn(gen, b, m, n, dtype=dt, device=cuda)
    c = _randn(gen, b, m, k, dtype=op, device=cuda)
    r = _randn(gen, b, k, n, dtype=op, device=cuda)
    got, want = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
    assert bool(((got - want).abs()
                 <= ref.panel_update_bound(a, c, r, want)).all())
    for i in range(b):
        assert torch.equal(got[i], k2.panel_update(a[i], c[i], r[i]))


@pytest.mark.parametrize("b,k,n,m0", [(1, 8, 64, 64), (3, 8, 64, 60),
                                      (40, 8, 64, 64), (4, 32, 300, 260),
                                      (2, 32, 8192, 8000),
                                      (2, 32, 28673, 28000)])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_stack_panel_factor_bitwise(cuda, b, k, n, m0, dt):
    gen = torch.Generator().manual_seed(7)
    panel = _randn(gen, b, k, n, dtype=dt, device=cuda)
    panel[-1, 1, 3] = float("nan")
    before = k4.launches
    R, ls, s, ld = k4.panel_factor(panel, m0, 1)
    assert k4.launches == before + 1
    R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, m0, 1)
    assert _same_bits(R, R0) and torch.equal(ls, ls0)
    assert _same_bits(s, s0)
    rtol = 1e-6 if dt == torch.float32 else 1e-14
    for i in range(b):
        assert _same_value(ld[i].item(), ld0[i].item(), rtol)
        R1, ls1, s1, ld1 = k4.panel_factor(panel[i], m0, 1)
        assert _same_bits(R[i], R1) and torch.equal(ls[i], ls1)
        assert _same_bits(s[i], s1) and _same_bits(ld[i], ld1)


STACK_ROUTES = {
    "staged|rank1": dict(method="exact"),
    "serial|panel": dict(method="exact", schedule="serial", update="panel",
                         k=8),
    "staged|panel": dict(method="exact", update="panel", k=8, min_size=16),
    "staged|rank1|fused": dict(method="exact", fused=True),
    "staged|panel|bf16": dict(method="exact", update="panel", k=8,
                              precision="bf16"),
    "ge": dict(method="ge"),
}


@pytest.mark.parametrize("route", sorted(STACK_ROUTES))
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_stack_plans_on_the_card(cuda, route, dt):
    """Each exact route on a (9, 70, 70) stack: the CPU's signs, log|det|
    within 1e-4 (f32) / 1e-10 (f64) (5e-3 with bf16 operands), matrix b
    bitwise the single-matrix plan on the card (panel: 1e-6 / 1e-12), and
    the single matrix's launch counts."""
    kw = STACK_ROUTES[route]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (9, 70, 70)) + 4.0 * np.eye(70)).to(dt)
    ops.reset_launch_counts()
    res = repro_torch.plan(x.to(cuda), **kw)()
    counts = ops.launch_counts()
    cpu = repro_torch.plan(x, device="cpu", **kw)()
    rtol = 5e-3 if "bf16" in route else (1e-4 if dt == torch.float32
                                         else 1e-10)
    assert torch.equal(res.sign.cpu(), cpu.sign)
    np.testing.assert_allclose(res.logabsdet.cpu().numpy(),
                               cpu.logabsdet.numpy(), rtol=rtol)
    for i in range(9):
        ops.reset_launch_counts()
        one = repro_torch.plan(x[i].to(cuda), **kw)()
        assert ops.launch_counts() == counts
        assert torch.equal(res.sign[i], one.sign)
        if "panel" in route:
            tol = 1e-6 if dt == torch.float32 else 1e-12
            assert abs(res.logabsdet[i].item() - one.logabsdet.item()) <= \
                tol * abs(one.logabsdet.item())
        else:
            assert torch.equal(res.logabsdet[i], one.logabsdet)


@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_batched_estimators_on_the_card(cuda, method):
    """A BatchedOperator on the card against the CPU with the same probes
    (and bounds): f64 rtol 1e-8; no kernel launched."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 80, 160))
    stack = torch.from_numpy(x @ x.transpose(0, 2, 1) / 160
                             + 2.0 * np.eye(80))
    z = torch.from_numpy(np.where(rng.random((4, 80, 16)) < 0.5, -1.0, 1.0))
    kw = dict(lmin=1.5, lmax=7.0) if method == "chebyshev" else {}
    ops.reset_launch_counts()
    got = repro_torch.plan(stack.to(cuda), method=method)(probes=z, **kw)
    assert not any(ops.launch_counts().values())
    want = repro_torch.plan(stack, method=method, device="cpu")(probes=z,
                                                                **kw)
    np.testing.assert_allclose(got.logabsdet.cpu().numpy(),
                               want.logabsdet.numpy(), rtol=1e-8)
    b = torch.from_numpy(rng.standard_normal((4, 80, 3)))
    cg = est.cg_solve(stack.to(cuda), b)
    assert bool(cg.converged) and not any(ops.launch_counts().values())
    np.testing.assert_allclose(cg.x.cpu().numpy(), torch.linalg.solve(
        stack, b).numpy(), rtol=1e-7, atol=1e-9)


def test_stack_grads_on_the_card(cuda):
    """value_and_grad on a stack: exact inv(A)^T with the forward's
    launches only; slq's pullback, no K7."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((5, 40, 80))
    stack = torch.from_numpy(x @ x.transpose(0, 2, 1) / 80
                             + 2.0 * np.eye(40)).to(cuda)
    inv_t = torch.linalg.inv(stack).mT
    p = repro_torch.plan(stack, method="exact", update="panel", k=8)
    ops.reset_launch_counts()
    p()
    fwd = ops.launch_counts()
    ops.reset_launch_counts()
    _, g = p.value_and_grad()
    assert ops.launch_counts() == fwd
    assert torch.allclose(g, inv_t, rtol=1e-10, atol=1e-12)
    ops.reset_launch_counts()
    res, g = repro_torch.plan(stack, method="slq").value_and_grad()
    assert ops.launch_counts()["cg_step"] == 0
    assert g.shape == stack.shape and res.logabsdet.shape == (5,)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("method", ["exact", "chebyshev", "slq"])
def test_gmm_fit_torch_on_the_card(cuda, method):
    """examples/gmm_fit_torch.py trains on the card through its one
    (K, d, d) plan with each method: every nll finite, the last below the
    first, exact's log|det| at the Cholesky reference."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    import gmm_fit_torch
    hist = gmm_fit_torch.train(dim=16, components=4, samples=800, steps=5,
                               method=method, device=cuda, log_every=0)
    assert hist["device"].startswith("cuda")
    nll = hist["nll"]
    assert np.isfinite(nll).all() and nll[-1] < nll[0]
    if method == "exact":
        assert hist["ld_gap"].max() < 1e-10


# serving: mixed sides over three rungs, f64, dominant diagonals (so the
# relative error of log|det| is a few ulps)
SERVE_SIDES = (5, 8, 13, 16, 30, 7, 9, 32, 61, 64)


def _dominant(rng, n):
    return rng.standard_normal((n, n)) + 2.0 * np.sqrt(n) * np.eye(n)


def _spd_host(rng, n):
    x = rng.standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + 2.0 * np.eye(n)


def test_service_drain_on_the_card(cuda):
    """`ServeConfig()` resolves to the card; a mixed-size drain run by the
    drain thread gives numpy's sign and log|det| within 1e-12 relative,
    each batched result bitwise the bucketed service's, K1 launching
    bucket - 1 times a batch and nothing else, and the kernels' libraries
    loaded by warmup."""
    from repro_torch import obs
    from repro_torch.serve import LogdetService, ServeConfig

    rng = np.random.default_rng(11)
    mats = [_dominant(rng, n) for n in SERVE_SIDES]
    prev = obs.mode()
    obs.configure("metrics")
    obs.reset()
    results = {}
    try:
        for max_batch in (1, 4):
            cfg = ServeConfig(buckets=(16, 32, 64), max_batch=max_batch,
                              max_wait_ms=5.0, default_method="exact")
            assert cfg.device.type == "cuda"
            with LogdetService(cfg) as svc:
                svc.warmup()
                assert svc.stats()["kernel_loads"] == 1
                before = {b: obs.counter_value("serve.batches",
                                               method="exact", bucket=b)
                          for b in cfg.buckets}
                ops.reset_launch_counts()
                futs = [svc.submit(a) for a in mats]
                got = [f.result(timeout=120) for f in futs]
                counts = ops.launch_counts()
                batches = {b: obs.counter_value("serve.batches",
                                                method="exact", bucket=b)
                           - c for b, c in before.items()}
                assert svc.stats()["kernel_loads"] == 1
            assert counts.pop("rank1_update") == sum(
                int(c) * (b - 1) for b, c in batches.items())
            assert not any(counts.values())
            for a, r in zip(mats, got):
                s, ld = np.linalg.slogdet(a)
                assert r.sign == s
                assert abs(r.logabsdet - ld) <= 1e-12 * abs(ld)
            results[max_batch] = [(r.sign, r.logabsdet) for r in got]
    finally:
        obs.reset()
        obs.configure(prev)
    assert results[4] == results[1]


def test_load_plan_on_the_card(cuda, tmp_path):
    """A plan exported on the card and loaded with no device runs on the
    card, bitwise the live plan (exact launching K1; slq with the same
    CUDA generator), its fingerprint naming the card and the kernel
    build."""
    from repro_torch.kernels import _build
    from repro_torch.serve.aot import read_header

    rng = np.random.default_rng(12)
    a, x = _dominant(rng, 40), _spd_host(rng, 48)
    for method, m in (("exact", a), ("slq", x)):
        p = repro_torch.plan(m.shape, method=method, precision="float64",
                             validate=False)
        path = str(tmp_path / f"{method}.repro-torch-plan")
        p.export(path)
        fp = read_header(path)["fingerprint"]
        assert fp["platform"] == "cuda"
        assert fp["device_kind"] == torch.cuda.get_device_name(0)
        assert fp["capability"] == list(torch.cuda.get_device_capability(0))
        assert fp["kernel_build"] == _build.digest()
        q = repro_torch.load_plan(path)
        assert q.device.type == "cuda" and q.diagnostics == p.diagnostics
        ops.reset_launch_counts()
        if method == "exact":
            got = q(m)
            assert ops.launch_counts()["rank1_update"] == 39
            want = p(m)
        else:
            got = q(m, generator=torch.Generator(device=cuda).manual_seed(3))
            assert not any(ops.launch_counts().values())
            want = p(m, generator=torch.Generator(device=cuda).manual_seed(3))
        assert got.logabsdet.device.type == "cuda"
        assert torch.equal(got.sign, want.sign)
        assert torch.equal(got.logabsdet, want.logabsdet)


def test_service_estimator_batch_on_the_card(cuda):
    """slq requests through the service on the card: each result bitwise
    the stack plan on the same padded stack with the CUDA generator the
    service draws for the batch (seeded by its counter), within 5 sem +
    1e-4 relative of Cholesky's log|det|, no kernel launched."""
    from repro_torch.serve import (
        LogdetService, ServeConfig, bucket_batch, stack_to_bucket,
    )

    rng = np.random.default_rng(13)
    mats = [_spd_host(rng, n) for n in (40, 50, 64)]
    cfg = ServeConfig(buckets=(64,), max_batch=4, max_wait_ms=1000.0,
                      seed=7)
    with LogdetService(cfg) as svc:
        ops.reset_launch_counts()
        futs = [svc.submit(a, method="slq") for a in mats]
        got = [f.result(timeout=120) for f in futs]
        counts = ops.launch_counts()
    assert not any(counts.values())
    stack = stack_to_bucket(mats, 64, bucket_batch(len(mats), 4))
    want = repro_torch.plan(stack.shape, method="slq", precision="float64",
                            validate=False)(
        stack, generator=torch.Generator(device=cuda).manual_seed(7))
    for i, (a, r) in enumerate(zip(mats, got)):
        assert r.logabsdet == want.logabsdet[i].item()
        assert r.sem == want.sem[i].item()
        ref_ld = 2.0 * np.log(np.diag(np.linalg.cholesky(a))).sum()
        assert abs(r.logabsdet - ref_ld) <= 5 * r.sem + 1e-4 * abs(ref_ld)


# --------------------------------------------------------------------------
# training (repro_torch.train / .checkpoint): the logdet aux through K1
# --------------------------------------------------------------------------

def _train_setup(device, name="adamw", mb=2):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, init_train_state
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name=name, weight_decay=0.01),
                       microbatches=mb, logdet_reg=0.05)
    state = init_train_state(cfg, tcfg, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    batch = synth_batch(cfg, DataConfig(seed=0, batch=4, seq=16), 0,
                        device="cpu")
    return cfg, tcfg, state, batch


def _state_to(state, device):
    import copy
    out = copy.deepcopy(state)
    out["params"] = out["params"].to(device)

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(device))
    out["opt"] = tree(out["opt"])
    out["step"] = out["step"].to(device)
    return out


def test_train_step_on_the_card_launches_k1_and_matches_the_cpu(cuda):
    """One adamw step (2 microbatches, logdet_reg) of qwen2.5-3b's smoke
    config: K1 launched 2 x (d_model - 1) times and nothing else; the
    clipped gradients within 1e-5 of the CPU's largest element; the
    card's update within 1e-5 (plus two f32 spacings) of the CPU
    optimizer applied to the card's own gradient; the metrics within
    1e-5 (grad_norm 1e-4)."""
    from repro_torch.optim import clip_by_global_norm, get_optimizer
    from repro_torch.train import make_grad_fn, make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, tcfg, state, batch = _train_setup("cpu")
    card = _state_to(state, cuda)
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    grad_fn = make_grad_fn(cfg, tcfg)
    gk, _ = clip_by_global_norm(grad_fn(card["params"], cbatch)[0],
                                tcfg.opt.clip_norm)
    gc, _ = clip_by_global_norm(grad_fn(state["params"], batch)[0],
                                tcfg.opt.clip_norm)
    gmax = max(float(v.abs().max()) for v in gc.values())
    for k in gc:
        assert (gk[k].cpu() - gc[k]).abs().max() <= 1e-5 * gmax, k
    cross = _state_to(state, "cpu")
    get_optimizer(tcfg.opt)[1]({k: v.cpu() for k, v in gk.items()},
                               cross["opt"], cross["params"])
    old = {k: p.detach().clone()
           for k, p in state["params"].named_parameters()}
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card, mk = step(card, cbatch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts.pop("rank1_update") == 2 * (cfg.d_model - 1)
    assert not any(counts.values()), counts
    state, mc = step(state, batch)
    for k in mc:
        rtol = 1e-4 if k == "grad_norm" else 1e-5
        assert float(mk[k]) == pytest.approx(float(mc[k]), rel=rtol), k
    new_x = dict(cross["params"].named_parameters())
    for k, p in card["params"].named_parameters():
        dk = p.detach().cpu().double() - old[k].double()
        dx = new_x[k].detach().double() - old[k].double()
        tol = 1e-5 * dx.abs() + 4 * 2.0 ** -23 * new_x[k].detach().abs()
        assert ((dk - dx).abs() <= tol.double() + 1e-300).all(), k
    assert int(card["step"]) == int(state["step"]) == 1


def test_checkpoint_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    """A card train state (adafactor's stacked moments) with a bf16 leaf,
    saved from the card, restores onto the CPU bit for bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    _, _, state, _ = _train_setup("cpu", name="adafactor", mb=1)
    card = _state_to(state, cuda)
    card["extra"] = {"half": torch.randn(5, 7, device=cuda)
                     .to(torch.bfloat16)}
    ckpt.save(tmp_path, card, 3)
    got, step = ckpt.restore(tmp_path, card, device="cpu")
    assert step == 3
    want = dict(card["params"].named_parameters())
    for k, p in got["params"].named_parameters():
        assert p.device.type == "cpu" and torch.equal(p, want[k].cpu()), k
    assert got["extra"]["half"].dtype == torch.bfloat16
    assert torch.equal(got["extra"]["half"].view(torch.int16),
                       card["extra"]["half"].cpu().view(torch.int16))
    for k, v in card["opt"]["f"]["blocks"]["mlp"]["w_up"].items():
        assert torch.equal(got["opt"]["f"]["blocks"]["mlp"]["w_up"][k],
                           v.cpu()), k


def test_logdet_decorrelation_grad_on_the_card(cuda, monkeypatch):
    """The aux on the card: value and gradient against the CPU's within
    2 sqrt(d) cond(Cov + eps I) 2^-24 (f32 in both: an f32 inverse's error
    model on each side); K1 launched d - 1 times by
    the forward and never by the backward (one inv_ex); no plain kernel
    version reached with a CUDA tensor."""
    from repro_torch.train.loss import logdet_decorrelation
    for name in dir(ref):
        fn = getattr(ref, name)
        if name.endswith("_ref") and callable(fn):
            def guard(*args, _fn=fn, _name=name, **kw):
                assert not any(isinstance(a, torch.Tensor) and a.is_cuda
                               for a in args), f"{_name} on a CUDA tensor"
                return _fn(*args, **kw)
            monkeypatch.setattr(ref, name, guard)
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 5, 24)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(h).to(dev).requires_grad_()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        v = logdet_decorrelation(x)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            fwd = ops.launch_counts()
            ops.reset_launch_counts()
        v.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            bwd = ops.launch_counts()
        out[dev.type] = (float(v.detach()), x.grad.double().cpu())
    assert fwd.pop("rank1_update") == h.shape[-1] - 1
    assert not any(fwd.values()) and not any(bwd.values()), (fwd, bwd)
    flat = torch.from_numpy(h.reshape(-1, h.shape[-1])).double()
    xc = flat - flat.mean(0)
    cov = xc.T @ xc / flat.shape[0] + 1e-3 * torch.eye(h.shape[-1],
                                                        dtype=torch.float64)
    ku = h.shape[-1] ** 0.5 * float(torch.linalg.cond(cov)) * 2.0 ** -24
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    g_card, g_cpu = out["cuda"][1], out["cpu"][1]
    assert float((g_card - g_cpu).abs().max() / g_cpu.abs().max()) <= 2 * ku


# --------------------------------------------------------------------------
# launch and sharding (repro_torch.launch / .sharding)
# --------------------------------------------------------------------------

def test_launch_train_on_the_card_launches_k1(cuda, tmp_path):
    """`launch.train` on one rank of the card with the logdet aux: K1
    steps x microbatches x (d_model - 1) times and nothing else, no
    collective, finite losses, the checkpoint written."""
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as M
    from repro_torch.launch import train as T
    args = T.parser().parse_args([
        "--arch", "gemma3-1b", "--steps", "2", "--batch", "4", "--seq", "16",
        "--microbatches", "2", "--logdet-reg", "0.05", "--ckpt-dir",
        str(tmp_path)])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    M.reset_collective_counts()
    state, losses, stats = T._run(args, T._mesh("1x1", None))
    counts = ops.launch_counts()
    d = get_config("gemma3-1b", smoke=True).d_model
    assert counts.pop("rank1_update") == 2 * 2 * (d - 1)
    assert not any(counts.values()), counts
    assert not any(M.collective_counts().values())
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert next(state["params"].parameters()).is_cuda
    assert [p.name for p in tmp_path.iterdir()] == ["step_00000002"]


def test_launch_grid_sharing_the_card_holds_the_split_steps_gates(cuda,
                                                                 tmp_path):
    """Four gloo ranks sharing the card on a 2x2 grid (the JAX launcher
    test's arguments, 6 steps, f32 activations, `launch.train.rank_main`)
    on the split step against one rank on the card: the first reduced
    gradient within 1e-5 of the largest element, its metrics within 1e-5,
    each step's loss within 1e-5; every rank's reduced gradient the same
    bits, the ranks that hold one block of a leaf the same bits, one more
    step's collectives equal to `layout.step_plan`, and the checkpoint in
    the one-rank run's format."""
    import json
    from repro_torch.core.mesh import run_ranks
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.sharding.layout import block_slices, flat
    from repro_torch.sharding.layout import state_shardings
    argv = ["--arch", "gemma3-1b", "--steps", "6", "--batch", "4", "--seq",
            "32", "--lr", "3e-3", "--ckpt-every", "25"]
    f32 = torch.float32
    one = run_ranks(T.rank_main, 1, backend="nccl", device="cuda",
                    timeout=300, args=(argv + ["--mesh", "1x1", "--ckpt-dir",
                                               str(tmp_path / "one")], None,
                                       True, None, False, f32))[0]
    grid = run_ranks(T.rank_main, 4, backend="gloo", device="cuda",
                     timeout=300, args=(argv + ["--mesh", "2x2", "--ckpt-dir",
                                                str(tmp_path / "grid")], None,
                                        True, None, False, f32))
    gmax = max(float(np.abs(v).max()) for v in one["grads"].values())
    for r in grid:
        assert all(r["grads"][k].tobytes() == v.tobytes()
                   for k, v in grid[0]["grads"].items())
        for k, g in r["grads"].items():
            assert float(np.abs(g - one["grads"][k]).max()) <= 1e-5 * gmax
        for k, v in one["grad_metrics"].items():
            assert abs(r["grad_metrics"][k] - v) <= 1e-5 * abs(v), k
        assert np.allclose(r["losses"], one["losses"], rtol=1e-5, atol=0)
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}
        assert all(k.startswith("params.") for k in plan["gathered"])
        assert r["blocks"]["step"] == 6
    args = T.parser().parse_args(argv + ["--device", "cpu"])
    cfg, state, _, _, _ = T.build(args.arch, smoke=True,
                                  mesh=T._mesh("1x1", "cpu"),
                                  tcfg=T._tcfg(args))
    sh = {".".join(p): s for p, s in flat(state_shardings(
        state, cfg, GridMesh(("data", "model"), (2, 2)), "adamw")).items()}
    for k, v in one["blocks"].items():
        held = {}
        for r in grid:
            where = str(block_slices(v.shape, sh[k], r["coords"]))
            held.setdefault(where, set()).add(r["blocks"][k].tobytes())
        assert all(len(x) == 1 for x in held.values()), k
    a, b = tmp_path / "one" / "step_00000006", tmp_path / "grid" / \
        "step_00000006"
    assert sorted(p.name for p in a.iterdir()) == sorted(
        p.name for p in b.iterdir())
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())


def test_launch_grid_faults_on_the_card_restart_every_rank(cuda, tmp_path):
    """tests/test_torch_launch_faults.py's run on four gloo ranks sharing
    the card: a fault on every rank, then on one rank inside the step and
    on one rank before a step; every rank restarts each time and the run
    ends with an uninterrupted run's blocks of the same grid, on the
    card."""
    from repro_torch.core.mesh import run_ranks
    from test_torch_ranks import FAULT_ARGV, FAULTS, launch_faults
    argv = [a if a != "cpu" else "cuda" for a in FAULT_ARGV]
    clean = run_ranks(launch_faults, 4, backend="gloo", device="cuda",
                      timeout=300, args=(argv + ["--mesh", "2x2"], {},
                                         str(tmp_path / "clean")))
    grid = run_ranks(launch_faults, 4, backend="gloo", device="cuda",
                     timeout=300, args=(argv + ["--mesh", "2x2"], FAULTS,
                                        str(tmp_path / "grid")))
    for want, r in zip(clean, grid):
        assert r["restarts"] == len(FAULTS) and want["restarts"] == 0
        assert r["coords"] == want["coords"]
        for k, v in want["blocks"].items():
            assert r["blocks"][k].tobytes() == v.tobytes(), k


def test_launch_serve_on_the_card_matches_the_cpu(cuda):
    """Greedy `generate` on the card against the CPU on the same
    parameters (f32): the same tokens (the smoke models' top-2 margins
    sit far above f32 rounding here), and the CLI's (2, 12)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import model as Mo
    from repro_torch.models.common import empty_init
    cfg = get_config("mamba2-370m", smoke=True).replace(
        dtype=torch.float32, remat=False)
    cpu = Mo.init_model(cfg, device="cpu")
    card = Mo.Model(cfg, empty_init(cuda))
    card.load_state_dict({k: v.to(cuda) for k, v in cpu.state_dict().items()})
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    a = S.generate(cpu, prompt, max_len=12, gen=4)
    b = S.generate(card, prompt.to(cuda), max_len=12, gen=4)
    assert torch.equal(a, b.cpu())
    toks = S.main(["--arch", "mamba2-370m", "--batch", "2", "--prompt-len",
                   "8", "--gen", "4"])
    assert tuple(toks.shape) == (2, 12) and toks.is_cuda


def test_masked_decode_write_on_the_card_is_index_copy(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as Mo
    from repro_torch.sharding import hints
    cfg = get_config("gemma3-1b", smoke=True).replace(remat=False)
    model = Mo.init_model(cfg, device=cuda)
    tok = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    outs = []
    for masked in (False, True):
        with torch.no_grad():
            _, caches = Mo.prefill(model, {"tokens": tok}, 8)
            try:
                hints.configure(cfg, make_production_mesh(),
                                kv_masked_write=masked)
                lg, caches = Mo.decode_step(model, tok[:, :1], caches, 4)
            finally:
                hints.configure(cfg, None)
        outs.append((lg, caches))
    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [] if t is None else [t]
    assert torch.equal(outs[0][0], outs[1][0])
    pairs = list(zip(leaves(outs[0][1]), leaves(outs[1][1])))
    assert pairs and all(torch.equal(x, y) for x, y in pairs)
