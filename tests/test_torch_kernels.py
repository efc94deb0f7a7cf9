"""repro_torch's plain K1-K4, reached through `repro_torch.kernels.ops` on
CPU tensors, against the JAX package's Pallas kernels run in interpret
mode, on the same numpy inputs.

Tolerances, as in tests/test_kernels.py:19-20 unless stated: f32
rtol = atol = 2e-5, f64 1e-12 -- the two frameworks may contract a
multiply-subtract into an FMA or sum a product in another order.  Within
the port, the fused step must equal the scatter swap + rank-1 update bit
for bit.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.condense_step import rank1_update_pallas
from repro.kernels.fused_step import fused_step_pallas
from repro.kernels.panel_factor import panel_factor_pallas
from repro.kernels.panel_update import panel_update_pallas

from repro_torch.core.engine import stage_schedule
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import condense_step as k1
from repro_torch.kernels import panel_factor as k4

SHAPES_R1 = [(8, 8), (64, 64), (100, 130), (256, 512), (33, 257)]
ODD_SHAPES_R1 = [(1, 1), (7, 129), (129, 7), (255, 383), (130, 130)]
SHAPES_PK = [(8, 8, 4), (64, 64, 8), (100, 130, 16), (256, 300, 32)]
ODD_SHAPES_PK = [(7, 129, 3), (65, 190, 33), (129, 257, 100), (50, 61, 50)]
PANELS = [(4, 32, 32), (8, 64, 50), (16, 128, 128), (16, 256, 200),
          (3, 33, 33), (5, 129, 100), (16, 200, 170), (32, 96, 96)]
DTYPES = [np.float32, np.float64]
# bf16 operands: the product rounds to bf16 in both frameworks; the two
# may land one bf16 ulp apart (at most 2^-7 of |pc * pr|) when an f32 ulp
# of difference upstream moves the rounding, or if XLA keeps the product
# in f32; allowed on top of the f32 tolerance
BF16_ULP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These matrices are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dt, odd=False):
    if dt == np.float64:
        return dict(rtol=1e-12, atol=1e-12)
    # K > 32 sums more terms: tests/test_kernels.py:136 widens to 2e-4
    return dict(rtol=2e-4, atol=2e-4) if odd else dict(rtol=2e-5, atol=2e-5)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


# ------------------------------------------------------------------ K1

@pytest.mark.parametrize("shape", SHAPES_R1 + ODD_SHAPES_R1)
@pytest.mark.parametrize("dt", DTYPES)
def test_rank1_update_matches_pallas(shape, dt, rng):
    m, n = shape
    a = rng.standard_normal((m, n)).astype(dt)
    pc = rng.standard_normal((m,)).astype(dt)
    pr = rng.standard_normal((n,)).astype(dt)
    want = np.asarray(rank1_update_pallas(a, pc, pr, interpret=True))
    got = ops.rank1_update(_t(a), _t(pc), _t(pr))
    assert got.dtype == _t(a).dtype
    np.testing.assert_allclose(got.numpy(), want, **_tol(dt))


@pytest.mark.parametrize("shape", [(33, 257), (64, 64), (7, 129)])
@pytest.mark.parametrize("dt", DTYPES)
def test_rank1_update_bf16_operands(shape, dt, rng):
    m, n = shape
    a = rng.standard_normal((m, n)).astype(dt)
    pc = rng.standard_normal((m,)).astype(np.float32)
    pr = rng.standard_normal((n,)).astype(np.float32)
    want = np.asarray(rank1_update_pallas(
        a, jnp.asarray(pc, jnp.bfloat16), jnp.asarray(pr, jnp.bfloat16),
        interpret=True))
    got = ops.rank1_update(_t(a), _t(pc), _t(pr), precision="bf16")
    assert got.dtype == _t(a).dtype
    prod = np.abs(np.multiply.outer(pc, pr))
    assert (np.abs(got.numpy() - want)
            <= BF16_ULP * prod + 2e-5 * (1 + np.abs(want))).all()


# ------------------------------------------------------------------ K2

@pytest.mark.parametrize("shape,odd", [(s, False) for s in SHAPES_PK]
                         + [(s, True) for s in ODD_SHAPES_PK])
@pytest.mark.parametrize("dt", DTYPES)
def test_panel_update_matches_pallas(shape, odd, dt, rng):
    m, n, k = shape
    a = rng.standard_normal((m, n)).astype(dt)
    c = rng.standard_normal((m, k)).astype(dt)
    r = rng.standard_normal((k, n)).astype(dt)
    want = np.asarray(panel_update_pallas(a, c, r, interpret=True))
    got = ops.panel_update(_t(a), _t(c), _t(r))
    np.testing.assert_allclose(got.numpy(), want, **_tol(dt, odd))


@pytest.mark.parametrize("shape", [(64, 64, 16), (65, 190, 33)])
@pytest.mark.parametrize("dt", DTYPES)
def test_panel_update_bf16_follows_the_kernel(shape, dt, rng):
    """bf16 operands are widened before the product (as the Pallas kernel
    does), never rounded to bf16 after it (as the jnp oracle would):
    compared with the interpret-mode kernel at the f32 tolerance."""
    m, n, k = shape
    a = rng.standard_normal((m, n)).astype(dt)
    c = rng.standard_normal((m, k)).astype(np.float32)
    r = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(panel_update_pallas(
        a, jnp.asarray(c, jnp.bfloat16), jnp.asarray(r, jnp.bfloat16),
        interpret=True))
    got = ops.panel_update(_t(a), _t(c), _t(r), precision="bf16")
    assert got.dtype == _t(a).dtype
    np.testing.assert_allclose(got.numpy(), want, **_tol(np.float32, True))


@pytest.mark.parametrize("shape", SHAPES_PK + ODD_SHAPES_PK)
@pytest.mark.parametrize("dt", DTYPES)
def test_panel_update_bound_admits_pallas_refuses_a_dropped_term(shape, dt,
                                                                 rng):
    """`ref.panel_update_bound`, which K2 on the card is held to, admits
    the Pallas kernel's own summation order and refuses a product that
    lacks one of its K terms."""
    m, n, k = shape
    a = rng.standard_normal((m, n)).astype(dt)
    c = rng.standard_normal((m, k)).astype(dt)
    r = rng.standard_normal((k, n)).astype(dt)
    ta, tc, tr = _t(a), _t(c), _t(r)
    plain = ref.panel_update_ref(ta, tc, tr)
    tol = ref.panel_update_bound(ta, tc, tr, plain)
    pallas = torch.from_numpy(
        np.asarray(panel_update_pallas(a, c, r, interpret=True)))
    assert bool(((pallas - plain).abs() <= tol).all())
    dropped = ta - tc[:, 1:] @ tr[1:]
    assert not bool(((dropped - plain).abs() <= tol).all())


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("n", [7, 37, 129, 200])
@pytest.mark.parametrize("dt", DTYPES)
def test_fused_step_matches_pallas(n, dt, rng):
    a = rng.standard_normal((n, n)).astype(dt)
    pc = rng.standard_normal((n,)).astype(dt)
    pr = rng.standard_normal((n,)).astype(dt)
    l, last = min(3, n - 1), n - 1
    want = np.asarray(fused_step_pallas(a, jnp.int32(l), jnp.int32(last), pc,
                                        pr, a[:, l], a[:, last],
                                        interpret=True))
    ta = _t(a)
    got = ref.fused_step_ref(ta, torch.tensor([l]), last, _t(pc), _t(pr),
                             ta[:, l].contiguous(), ta[:, last].contiguous())
    np.testing.assert_allclose(got.numpy(), want, **_tol(dt))


@pytest.mark.parametrize("op_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_fused_step_is_scatter_swap_plus_rank1_bitwise(dt, op_dtype, rng):
    n = 37
    a = _t(rng.standard_normal((n, n)), dt)
    pc = _t(rng.standard_normal((n,)), op_dtype or dt)
    pr = _t(rng.standard_normal((n,)), op_dtype or dt)
    l, last = 5, n - 1
    col_l, col_last = a[:, l].clone(), a[:, last].clone()
    fused = ref.fused_step_ref(a, torch.tensor([l]), last, pc, pr, col_l,
                               col_last)
    sw = a.clone()
    sw[:, l], sw[:, last] = col_last, col_l
    assert torch.equal(fused, ref.rank1_update_ref(sw, pc, pr))


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("dt", DTYPES)
def test_fused_condense_step_matches_jax(dt, precision, rng):
    """The whole one-pass step (pivot bookkeeping + K3) against the JAX
    entry point on its interpret-mode kernel, mid-condensation."""
    n = 37
    buf = rng.standard_normal((n, n)).astype(dt)
    for t in (0, 3, n - 2):
        jout, jl, jp = jax_ops.fused_condense_step(
            jnp.asarray(buf), t, backend="interpret", precision=precision)
        out, l, p = ops.fused_condense_step(_t(buf), t, precision=precision)
        assert int(l[0]) == int(jl)
        assert float(p) == float(jp)
        jout = np.asarray(jout)
        if precision is None:
            np.testing.assert_allclose(out.numpy(), jout, **_tol(dt))
        else:
            _, _, pc, pr, _, _ = ops.pivot_operands(_t(buf), t)
            prod = torch.outer(pc, pr).abs().numpy()
            assert (np.abs(out.numpy() - jout)
                    <= BF16_ULP * prod + 2e-5 * (1 + np.abs(jout))).all()


def test_fused_condense_step_zero_pivot_row(rng):
    """An all-zero live row gives p == 0, a zero pr and no NaNs, as in the
    JAX package (tests/test_kernels.py:318)."""
    n = 9
    buf = rng.standard_normal((n, n)).astype(np.float32)
    buf[0] = 0.0
    out, l, p = ops.fused_condense_step(_t(buf), 0)
    jout, jl, jp = jax_ops.fused_condense_step(jnp.asarray(buf), 0,
                                               backend="interpret")
    assert float(p) == 0.0 and int(l[0]) == int(jl)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **_tol(
        np.float32))


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("k,n,m0", PANELS)
@pytest.mark.parametrize("dt", DTYPES)
def test_panel_factor_matches_pallas(k, n, m0, dt, rng):
    panel = rng.standard_normal((k, n)).astype(dt)
    R1, ls1, s1, ld1 = panel_factor_pallas(jnp.asarray(panel), m0, 3,
                                           interpret=True)
    R2, ls2, s2, ld2 = ops.panel_factor(_t(panel), m0, 3)
    assert ls2.dtype == torch.int64
    np.testing.assert_array_equal(ls2.numpy(), np.asarray(ls1))
    assert float(s2) == float(s1)
    np.testing.assert_allclose(R2.numpy(), np.asarray(R1), **_tol(dt))
    rtol = 1e-6 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(float(ld2), float(ld1), rtol=rtol)


def test_panel_factor_zero_pivot_row(rng):
    """A zero live row inside a panel: p == 0 makes the sign 0, R stays
    finite, and both packages agree."""
    panel = rng.standard_normal((4, 16)).astype(np.float64)
    panel[2] = 0.0
    R1, ls1, s1, _ = panel_factor_pallas(jnp.asarray(panel), 16, 0,
                                         interpret=True)
    R2, ls2, s2, _ = ops.panel_factor(_t(panel), 16, 0)
    assert float(s2) == float(s1) == 0.0
    assert torch.isfinite(R2).all()
    np.testing.assert_array_equal(ls2.numpy(), np.asarray(ls1))
    np.testing.assert_allclose(R2.numpy(), np.asarray(R1), **_tol(
        np.float64))


@pytest.mark.parametrize("where,live", [((0, 5), True), ((2, 11), True),
                                        ((7, 35), True), ((6, 39), False)])
@pytest.mark.parametrize("dt", DTYPES)
def test_panel_factor_nan_entry(where, live, dt, rng):
    """A NaN entry: the same pivots and NaN positions in both packages,
    and a NaN sign when the entry lies in the live columns [0, m0) (not
    the 0 of a singular panel); a NaN in a dead column leaves the sign
    alone in both."""
    panel = rng.standard_normal((8, 40)).astype(dt)
    panel[where] = np.nan
    R1, ls1, s1, ld1 = panel_factor_pallas(jnp.asarray(panel), 36, 1,
                                           interpret=True)
    R2, ls2, s2, ld2 = ops.panel_factor(_t(panel), 36, 1)
    np.testing.assert_array_equal(ls2.numpy(), np.asarray(ls1))
    np.testing.assert_array_equal(np.isnan(R2.numpy()),
                                  np.isnan(np.asarray(R1)))
    np.testing.assert_allclose(R2.numpy(), np.asarray(R1), **_tol(dt))
    if live:
        assert np.isnan(float(s1)) and torch.isnan(s2)
    else:
        assert float(s2) == float(s1) in (-1.0, 1.0)
        np.testing.assert_allclose(float(ld2), float(ld1), rtol=1e-6)


def test_panel_factor_leaves_its_input_alone(rng):
    panel = _t(rng.standard_normal((4, 16)))
    before = panel.clone()
    ops.panel_factor(panel, 16)
    assert torch.equal(panel, before)


# ------------------------------------------------------- K4 launch plan

# the panel widths of the N = 8192 routes: every stage of the staged
# schedule (panels of stage size) and the mesh's full width
K4_WIDTHS = sorted({size for size, _ in stage_schedule(8192, 0.75, 64)}
                   | {8192})


def _assert_covers(p, n):
    """Block r owns [r * cols, min((r + 1) * cols, n)): every column once,
    no block empty, as the C entry requires."""
    owned = np.zeros(n, dtype=int)
    for r in range(p.cluster):
        assert r * p.cols < n
        owned[r * p.cols:(r + 1) * p.cols] += 1
    assert (owned == 1).all()
    assert 1 <= p.cluster <= k4.MAX_CLUSTER <= 16
    assert p.cols % k4.COL_ALIGN == 0


@pytest.mark.parametrize("n", K4_WIDTHS)
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_panel_factor_plan_covers_the_route_widths(n, dt):
    """Every width of the staged and mesh routes at N = 8192 keeps its
    slices in shared memory, within one block's 232,448 bytes; narrow
    panels take fewer blocks."""
    p = k4.plan(32, n, dt)
    _assert_covers(p, n)
    assert p.shared
    assert p.smem_bytes == k4.smem_bytes(32, p.cols, dt.itemsize, True)
    assert p.smem_bytes + k4.STATIC_SMEM <= k4.SMEM_PER_BLOCK == 232448
    assert p.cluster == min(k4.MAX_CLUSTER, -(-n // p.cols))
    if n <= k4.MIN_COLS:
        assert p.cluster == 1
    if n >= k4.MAX_CLUSTER * k4.MIN_COLS:
        assert p.cluster == k4.MAX_CLUSTER


@pytest.mark.parametrize("k,n,dt,shared", [
    (32, 28672, torch.float32, True), (32, 28673, torch.float32, False),
    (32, 65536, torch.float32, False), (32, 14336, torch.float64, True),
    (32, 14337, torch.float64, False), (1024, 8192, torch.float32, False),
    (1024, 64, torch.float32, True), (1024, 64, torch.float64, False),
    (1, 1, torch.float32, True), (1, 33, torch.float64, True),
    (64, 8191, torch.float32, True), (700, 777, torch.float64, False)])
def test_panel_factor_plan_past_shared_memory(k, n, dt, shared):
    """A panel whose slices fit no cluster's shared memory takes the
    global-memory branch, on the widest cluster; one that fits only on
    more blocks than the width asks for gets them."""
    p = k4.plan(k, n, dt)
    _assert_covers(p, n)
    assert p.shared == shared
    if shared:
        assert p.smem_bytes == k4.smem_bytes(k, p.cols, dt.itemsize, True)
        assert p.smem_bytes + k4.STATIC_SMEM <= k4.SMEM_PER_BLOCK
    else:
        assert p.smem_bytes == k4.smem_bytes(k, p.cols, dt.itemsize, False)
        # the widest cluster: ceil(n / 16) columns each, warp-aligned
        per_block = -(-n // k4.MAX_CLUSTER)
        assert p.cols == -(-per_block // k4.COL_ALIGN) * k4.COL_ALIGN


@pytest.mark.parametrize("k", [0, -1, k4.MAX_ROWS + 1])
def test_panel_factor_plan_rejects_k(k):
    with pytest.raises(ValueError, match=f"K={k}"):
        k4.plan(k, 8192, torch.float32)


# ------------------------------------------------------------ dispatch

def test_launch_counters_stay_zero_on_the_cpu(rng):
    ops.reset_launch_counts()
    a = _t(rng.standard_normal((8, 8)))
    ops.rank1_update(a, a[0], a[1])
    ops.panel_update(a, a[:, :2].contiguous(), a[:2].contiguous())
    ops.fused_condense_step(a, 0)
    ops.panel_factor(a[:2], 8)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_other_devices_raise():
    a = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.rank1_update(a, a[0], a[1])


def test_wrappers_refuse_cpu_tensors(rng):
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself."""
    a = _t(rng.standard_normal((4, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        k1.rank1_update(a, a[0].clone(), a[1].clone())


def test_missing_compiler_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
