"""repro_torch's plain K6 (cheb_step), K7 (cg_step) and K8 (stencil_mv),
reached through `repro_torch.kernels.ops` on CPU tensors, against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerances: K6 and K7 within twice the rounding bound of one evaluation,
`ref.cheb_step_bound` / `ref.cg_step_bound` (the two frameworks sum
``A @ w`` and the column dots in other orders, and XLA may contract a
multiply-subtract of the epilogue into an FMA: one rounding of
``|center * w| / |width|`` is added for that); a converged CG column
(zero denominator) is an exact no-op in both.  K8 f64 within 1e-12 and
f32 within 2e-5 (tests/test_operators.py's tolerance; XLA may contract
the band multiply-add).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.fused_est import cg_step_pallas, cheb_step_pallas
from repro.kernels.stencil_mv import stencil_mv_pallas

from repro_torch.kernels import fused_est, ops, ref
from repro_torch.kernels import stencil_mv as k8

ROOT = Path(__file__).resolve().parents[1]
DTYPES = [np.float32, np.float64]
# tests/test_kernels.py:348 plus n = 1 and a width past one 32-column tile
EST_SHAPES = [(8, 3), (37, 5), (130, 7), (1, 1), (70, 33)]
# tests/test_operators.py:199-214: bm not dividing n, n = 1
STENCILS = [(11, (-1, 0, 1), 4), (300, (-3, -1, 0, 2, 7), 256),
            (1, (0,), 8), (37, (-5, 0, 5), 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These operands are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _within(got, want, tol):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff <= np.asarray(tol)).all(), float(diff.max())


@pytest.mark.parametrize("shape", EST_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_cheb_step_matches_pallas(shape, dt, rng):
    n, k = shape
    a, w, wp, v = (rng.standard_normal(s).astype(dt)
                   for s in ((n, n), (n, k), (n, k), (n, k)))
    center, width = 1.7, 3.1
    want_w, want_d = cheb_step_pallas(a, w, wp, v, center, width,
                                      interpret=True)
    c_t = torch.tensor([[center]], dtype=_t(a).dtype)
    wd_t = torch.tensor([[width]], dtype=_t(a).dtype)
    got_w, got_d = ops.fused_cheb_step(_t(a), _t(w), _t(wp), _t(v), c_t,
                                       wd_t)
    assert got_w.dtype == _t(a).dtype and got_d.shape == (k,)
    tol_w, tol_d = ref.cheb_step_bound(_t(a), _t(w), _t(wp), _t(v), c_t,
                                       wd_t)
    eps = np.finfo(dt).eps
    tol_w = 2 * tol_w.numpy() + 2 * eps * np.abs(center * w) / width
    tol_d = 2 * tol_d.numpy() + (np.abs(v) * tol_w).sum(0)
    _within(got_w.numpy(), want_w, tol_w)
    _within(got_d.numpy(), want_d, tol_d)


def test_cheb_step_takes_host_numbers_on_the_cpu(rng):
    a, w, wp, v = (_t(rng.standard_normal(s)) for s in ((9, 9),) + ((9, 2),) * 3)
    got = ops.fused_cheb_step(a, w, wp, v, 1.5, 2.5)
    want = ops.fused_cheb_step(a, w, wp, v, torch.tensor([[1.5]]).double(),
                               torch.tensor([[2.5]]).double())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", EST_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_cg_step_matches_pallas(shape, dt, rng):
    n, k = shape
    a, p, x, r = (rng.standard_normal(s).astype(dt)
                  for s in ((n, n), (n, k), (n, k), (n, k)))
    rz = rng.standard_normal((k,)).astype(dt)
    p[:, 0] = 0.0                   # a converged column: den = 0 -> alpha = 0
    want_x, want_r = cg_step_pallas(a, p, x, r, rz, interpret=True)
    got_x, got_r = ops.fused_cg_step(_t(a), _t(p), _t(x), _t(r), _t(rz))
    tol_x, tol_r = ref.cg_step_bound(_t(a), _t(p), _t(x), _t(r), _t(rz))
    _within(got_x.numpy(), want_x, 2 * tol_x.numpy())
    _within(got_r.numpy(), want_r, 2 * tol_r.numpy())
    np.testing.assert_array_equal(got_x.numpy()[:, 0], x[:, 0])
    np.testing.assert_array_equal(got_r.numpy()[:, 0], r[:, 0])


def test_cg_step_converged_columns_take_noops():
    """tests/test_kernels.py's no-op case: alpha is exactly 0, not NaN."""
    a = torch.eye(16)
    p = torch.zeros((16, 3))
    x, r = torch.ones((16, 3)), torch.ones((16, 3))
    x1, r1 = ops.fused_cg_step(a, p, x, r, torch.ones(3))
    assert torch.equal(x1, x) and torch.equal(r1, r)


@pytest.mark.parametrize("n,offsets,bm", STENCILS)
@pytest.mark.parametrize("dt", DTYPES)
def test_stencil_mv_matches_pallas(n, offsets, bm, dt, rng):
    bands = rng.standard_normal((len(offsets), n)).astype(dt)
    x = rng.standard_normal((n, 3)).astype(dt)
    want = stencil_mv_pallas(jnp.asarray(bands), jnp.asarray(x),
                             offsets=offsets, bm=bm, interpret=True)
    got = ops.stencil_mv(_t(bands), _t(x), offsets=offsets)
    tol = dict(rtol=1e-12, atol=1e-12) if dt == np.float64 else \
        dict(rtol=2e-5, atol=2e-5)
    assert got.dtype == _t(bands).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_stencil_mv_vector_form(dt, rng):
    bands = rng.standard_normal((3, 50)).astype(dt)
    v = rng.standard_normal((50,)).astype(dt)
    want = stencil_mv_pallas(jnp.asarray(bands), jnp.asarray(v),
                             offsets=(-1, 0, 1), interpret=True)
    got = ops.stencil_mv(_t(bands), _t(v), offsets=(-1, 0, 1))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5 if dt == np.float32 else 1e-12)


def test_stencil_mv_reads_zeros_outside(rng):
    """The Dirichlet boundary: a band reaching past either end adds 0."""
    x = _t(rng.standard_normal((6, 2)))
    ones = torch.ones((2, 6), dtype=x.dtype)
    y = ops.stencil_mv(ones, x, offsets=(-2, 3))
    want = torch.zeros_like(x)
    want[2:] += x[:4]
    want[:3] += x[3:]
    assert torch.equal(y, want)


def test_estimator_counters_stay_zero_on_the_cpu(rng):
    ops.reset_launch_counts()
    a = _t(rng.standard_normal((8, 8)))
    w = _t(rng.standard_normal((8, 2)))
    ops.fused_cheb_step(a, w, w, w, 1.0, 2.0)
    ops.fused_cg_step(a, w, w, w, w[0].clone())
    ops.stencil_mv(a[:3].contiguous(), w, offsets=(-1, 0, 1))
    counts = ops.launch_counts()
    assert {"cheb_step", "cg_step", "stencil_mv"} <= set(counts)
    assert counts == dict.fromkeys(ops.KERNELS, 0)


def test_estimator_wrappers_refuse_cpu_tensors(rng):
    """A wrapper launches its kernel or raises; it never computes the
    plain version itself."""
    a = _t(rng.standard_normal((4, 4)))
    w = _t(rng.standard_normal((4, 2)))
    one = torch.ones(1, dtype=a.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        fused_est.cheb_step(a, w, w, w, one, one)
    with pytest.raises(ValueError, match="CUDA"):
        fused_est.cg_step(a, w, w, w, torch.ones(2, dtype=a.dtype))
    with pytest.raises(ValueError, match="CUDA"):
        k8.stencil_mv(a[:1].contiguous(), w, (0,))


def test_batched_operands_raise(rng):
    """K6/K7 take one matrix: a stack runs as a `BatchedOperator`, whose
    products never reach them (the JAX package silently takes its jnp
    reference there)."""
    a = torch.zeros((2, 4, 4))
    w = torch.zeros((2, 4, 1))
    with pytest.raises(ValueError, match="BatchedOperator"):
        ops.fused_cheb_step(a, w, w, w, 1.0, 2.0)
    with pytest.raises(ValueError, match="BatchedOperator"):
        ops.fused_cg_step(a, w, w, w, torch.ones(2, 1))


def test_stencil_other_devices_raise():
    b = torch.empty((1, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.stencil_mv(b, torch.empty((4, 1), device="meta"), offsets=(0,))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", EST_SHAPES)
@pytest.mark.parametrize("kernel", ["cheb_step", "cg_step"])
def test_f32_steps_within_their_rounding_bound(kernel, shape, rng):
    """The plain f32 step against the same step in f64: within one
    evaluation's bound (`ref.cheb_step_bound` / `ref.cg_step_bound`)."""
    n, k = shape
    a, w, x, v = (_t(rng.standard_normal(s).astype(np.float32))
                  for s in ((n, n), (n, k), (n, k), (n, k)))
    if kernel == "cheb_step":
        args = (a, w, x, v, torch.tensor([1.7]), torch.tensor([3.1]))
        step, bound = ref.cheb_step_ref, ref.cheb_step_bound
    else:
        args = (a, w, x, v, _t(rng.standard_normal(k).astype(np.float32)))
        step, bound = ref.cg_step_ref, ref.cg_step_bound
    got = step(*args)
    want = step(*(t.double() for t in args))
    for g, w64, tol in zip(got, want, bound(*args)):
        assert ((g.double() - w64).abs() <= tol.double()).all()


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["cheb_step", "cg_step"])
def test_chip_smoke_check_rejects_planted_faults(kernel, dt):
    """chip_smoke.py's K6/K7 check on the routes' own operands (a small
    dense SPD matrix): the plain version passes, each planted fault (a
    skipped chunk of A, zeroed dots, a negated alpha) fails."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(96, 96, generator=gen, dtype=torch.float64)
    a = (x @ x.T / 96 + 2 * torch.eye(96, dtype=torch.float64)).to(dt)
    inputs = (smoke.cheb_step_inputs if kernel == "cheb_step"
              else smoke.cg_step_inputs)
    step = getattr(ref, kernel + "_ref")
    bound = getattr(ref, kernel + "_bound")
    before = a.clone()
    args = (a, *inputs(a, gen))
    outs = step(*args)
    assert smoke.held(step, bound, args, outs) <= 1.0
    faults = smoke.planted_faults(kernel, args, outs)
    assert len(faults) == 2
    for name, bad in faults.items():
        assert smoke.held(step, bound, args, bad) > 1.0, name
    assert torch.equal(a, before)            # the operands are left alone
