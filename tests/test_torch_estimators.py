"""repro_torch.estimators against repro.estimators on the same numpy arrays.

The two packages draw other random numbers from the same seed, so every
estimator comparison hands both the same ``probes`` and, for Chebyshev,
the same ``lmin``/``lmax``.  `spectral_bounds` starts from a random
vector and is checked by property instead: the bracket contains the
spectrum ``eigvalsh`` gives.

Tolerances: f64 relative 1e-10 on estimates, samples, coefficients and
CG solutions (the frameworks sum in other orders; the recurrences carry
the difference a few dozen steps); f32 relative 1e-4; the stencil
operator's materialization and products 1e-12 in f64.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.estimators as jest

from repro_torch import estimators as est
from repro_torch.core.mesh import Mesh
from repro_torch.estimators.operators.stencil import _transpose_bands


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These operands are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(n, seed=0, shift=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + shift * np.eye(n)


def _lattice_bands(side, kappa2=0.1):
    """The SPDE / Matern precision kappa^2 I + 2-D Laplacian (Dirichlet)."""
    n = side * side
    i = np.arange(n)
    bands = np.full((5, n), -1.0)
    bands[2] = 4.0 + kappa2
    bands[1][i % side == 0] = 0.0
    bands[3][i % side == side - 1] = 0.0
    return (-side, -1, 0, 1, side), bands


def _probes(n, k, seed=1, kind="rademacher"):
    rng = np.random.default_rng(seed)
    if kind == "rademacher":
        return rng.choice([-1.0, 1.0], size=(n, k))
    return rng.standard_normal((n, k))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


RTOL = {np.float64: 1e-10, np.float32: 1e-4}


# ------------------------------------------------------------ hutchinson

@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_make_probes(kind):
    g = torch.Generator().manual_seed(0)
    v = est.make_probes(g, 40, 7, kind=kind, dtype=torch.float64)
    assert v.shape == (40, 7) and v.dtype == torch.float64
    if kind == "rademacher":
        assert set(v.unique().tolist()) == {-1.0, 1.0}
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(v, est.make_probes(g2, 40, 7, kind=kind,
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="probe kind"):
        est.make_probes(g, 4, 2, kind="sobol")
    with pytest.raises(ValueError, match="floating"):
        est.make_probes(g, 4, 2, dtype=torch.int32)


@pytest.mark.parametrize("k", [1, 2, 9])
def test_mean_sem_matches_jax(k):
    s = np.random.default_rng(2).standard_normal(k)
    e, m = est.mean_sem(torch.from_numpy(s))
    je, jm = jest.mean_sem(jnp.asarray(s))
    assert _rel(e, je) < 1e-12
    if k < 2:
        assert np.isinf(float(m)) and np.isinf(float(jm))
    else:
        assert _rel(m, jm) < 1e-12


def test_hutchinson_trace_matches_jax():
    a = _spd(30)
    v = _probes(30, 12)
    t = torch.from_numpy(a)
    res = est.hutchinson_trace(lambda x: t @ x, torch.from_numpy(v),
                               device="cpu")
    jres = jest.hutchinson_trace(lambda x: jnp.asarray(a) @ x, jnp.asarray(v))
    for f in ("est", "sem"):
        assert _rel(getattr(res, f), getattr(jres, f)) < 1e-12
    np.testing.assert_allclose(res.samples.numpy(), np.asarray(jres.samples),
                               rtol=1e-12)


# ------------------------------------------------------------- chebyshev

@pytest.mark.parametrize("lo,hi,degree", [(0.5, 4.0, 8), (1e-3, 10.0, 32),
                                          (2.0, 2.5, 1)])
def test_chebyshev_coeffs_match_jax(lo, hi, degree):
    c = est.chebyshev_coeffs_log(lo, hi, degree, torch.float64, "cpu")
    jc = jest.chebyshev_coeffs_log(lo, hi, degree, jnp.float64)
    assert c.shape == (degree + 1,)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("kind", ["dense", "stencil"])
def test_spectral_bounds_bracket_the_spectrum(kind):
    if kind == "dense":
        op = est.DenseOperator(torch.from_numpy(_spd(40, seed=3)))
    else:
        rng = np.random.default_rng(4)
        off = rng.uniform(-1.0, -0.2, 29)
        bands = np.stack([np.r_[0.0, off], 2.5 + rng.uniform(0, 1, 30),
                          np.r_[off, 0.0]])
        op = est.StencilOperator((-1, 0, 1), torch.from_numpy(bands))
    eig = np.linalg.eigvalsh(op.to_dense().numpy())
    for seed in range(3):
        lo, hi = est.spectral_bounds(op, torch.Generator().manual_seed(seed))
        assert 0 < float(lo) <= eig[0] and eig[-1] <= float(hi)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["rademacher", "gaussian"])
def test_logdet_chebyshev_dense_matches_jax(dt, kind):
    a = _spd(48).astype(dt)
    v = _probes(48, 16, kind=kind).astype(dt)
    kw = dict(degree=24, lmin=0.8, lmax=6.0)
    res = est.logdet_chebyshev(torch.from_numpy(a), probes=torch.from_numpy(v),
                               device="cpu", **kw)
    jres = jest.logdet_chebyshev(jnp.asarray(a), probes=jnp.asarray(v), **kw)
    assert res.est.dtype == torch.from_numpy(a).dtype
    assert _rel(res.est, jres.est) < RTOL[dt]
    assert _rel(res.sem, jres.sem) < 10 * RTOL[dt]
    np.testing.assert_allclose(res.samples.numpy(), np.asarray(jres.samples),
                               rtol=RTOL[dt])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_logdet_chebyshev_stencil_matches_jax(dt):
    offsets, bands = _lattice_bands(8)
    bands = bands.astype(dt)
    v = _probes(64, 12).astype(dt)
    kw = dict(degree=32, lmin=0.05, lmax=8.5)
    res = est.logdet_chebyshev(est.StencilOperator(offsets,
                                                   torch.from_numpy(bands)),
                               probes=torch.from_numpy(v), device="cpu", **kw)
    jres = jest.logdet_chebyshev(jest.StencilOperator(offsets,
                                                      jnp.asarray(bands)),
                                 probes=jnp.asarray(v), **kw)
    assert _rel(res.est, jres.est) < RTOL[dt]


def test_logdet_chebyshev_is_close_to_the_truth():
    """Power-iteration bounds and seeded probes: within 4 sem + 1 % of the
    closed-form log-determinant of the lattice."""
    offsets, bands = _lattice_bands(12)
    side = 12
    th = np.arange(1, side + 1) * np.pi / (side + 1)
    truth = np.log(4.1 - 2 * np.cos(th)[:, None]
                   - 2 * np.cos(th)[None, :]).sum()
    op = est.StencilOperator(offsets, torch.from_numpy(bands))
    assert abs(np.linalg.slogdet(op.to_dense().numpy())[1] - truth) < 1e-9
    for method in ("chebyshev", "slq"):
        res = est.estimate_logdet(op, method=method, num_probes=64, seed=3,
                                  device="cpu")
        assert abs(float(res.est) - truth) <= 4 * float(res.sem) + 1e-2 * truth


def test_logdet_chebyshev_rejects_bad_input():
    with pytest.raises(ValueError, match="degree"):
        est.logdet_chebyshev(torch.eye(3, dtype=torch.float64), degree=0,
                             device="cpu")
    with pytest.raises(ValueError, match="probes rows"):
        est.logdet_chebyshev(torch.eye(3, dtype=torch.float64),
                             probes=torch.ones(4, 2, dtype=torch.float64),
                             lmin=0.5, lmax=2.0, device="cpu")


# ------------------------------------------------------------------- slq

@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["dense", "stencil"])
def test_logdet_slq_matches_jax(dt, kind):
    if kind == "dense":
        a = _spd(40).astype(dt)
        op, jop, n = torch.from_numpy(a), jnp.asarray(a), 40
    else:
        offsets, bands = _lattice_bands(7)
        bands = bands.astype(dt)
        op = est.StencilOperator(offsets, torch.from_numpy(bands))
        jop = jest.StencilOperator(offsets, jnp.asarray(bands))
        n = 49
    v = _probes(n, 10, kind="gaussian").astype(dt)
    res = est.logdet_slq(op, num_steps=12, probes=torch.from_numpy(v),
                         device="cpu")
    jres = jest.logdet_slq(jop, num_steps=12, probes=jnp.asarray(v))
    assert _rel(res.est, jres.est) < RTOL[dt]
    np.testing.assert_allclose(res.samples.numpy(), np.asarray(jres.samples),
                               rtol=10 * RTOL[dt])


def test_lanczos_and_beta_pad_match_jax():
    a = _spd(20, seed=5)
    v = _probes(20, 3)
    t = torch.from_numpy(a)
    al, be = est.lanczos(lambda x: t @ x, torch.from_numpy(v), 20)
    jal, jbe = jest.lanczos(lambda x: jnp.asarray(a) @ x, jnp.asarray(v), 20)
    assert al.shape == (3, 20) and be.shape == (3, 19)
    np.testing.assert_allclose(al.numpy(), np.asarray(jal), rtol=1e-9)
    # past the Krylov space's exhaustion beta is rounding noise in both
    np.testing.assert_allclose(be.numpy()[:, :-1], np.asarray(jbe)[:, :-1],
                               rtol=1e-8, atol=1e-12)
    from repro.estimators.slq import beta_pad as jbeta_pad
    np.testing.assert_array_equal(est.beta_pad(be, 20).numpy()[:, :-1],
                                  be.numpy())
    assert jbeta_pad(jbe, 20).shape == est.beta_pad(be, 20).shape


def test_slq_probe_count_larger_than_n():
    """num_steps > n is capped at n, as in the JAX package."""
    a = _spd(6)
    v = _probes(6, 4)
    res = est.logdet_slq(torch.from_numpy(a), num_steps=25,
                         probes=torch.from_numpy(v), device="cpu")
    jres = jest.logdet_slq(jnp.asarray(a), num_steps=25, probes=jnp.asarray(v))
    assert _rel(res.est, jres.est) < 1e-8


# ------------------------------------------------------------ cg_solve

def _sym_stencil(n, seed):
    rng = np.random.default_rng(seed)
    off = rng.uniform(-1.0, -0.1, n - 3)
    bands = np.stack([np.r_[np.zeros(3), off], 3.0 + rng.uniform(0, 2, n),
                      np.r_[off, np.zeros(3)]])
    return (-3, 0, 3), bands


@pytest.mark.parametrize("case", ["dense", "stencil", "dense_t", "stencil_t",
                                  "dense_x0", "stencil_x0", "vector",
                                  "zero_col", "no_precond"])
def test_cg_solve_matches_jax(case):
    n = 45
    rng = np.random.default_rng(6)
    if case.startswith("stencil"):
        offsets, bands = _sym_stencil(n, 7)
        op = est.StencilOperator(offsets, torch.from_numpy(bands))
        jop = jest.StencilOperator(offsets, jnp.asarray(bands))
    else:
        a = _spd(n, seed=8)
        op, jop = torch.from_numpy(a), jnp.asarray(a)
    b = rng.standard_normal((n,) if case == "vector" else (n, 3))
    if case == "zero_col":
        b[:, 1] = 0.0
    kw = dict(tol=1e-12)
    if case.endswith("_t"):
        kw["transpose"] = True
    if case.endswith("_x0"):
        kw["x0"] = rng.standard_normal((n, 3))
    if case == "no_precond":
        kw["precondition"] = False
    res = est.cg_solve(op, torch.from_numpy(b), device="cpu", **{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    jres = jest.cg_solve(jop, jnp.asarray(b), **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
        for k, v in kw.items()})
    assert bool(res.converged) and bool(jres.converged)
    assert abs(res.iters - int(jres.iters)) <= 1
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-10,
                               atol=1e-12)
    if case == "zero_col":
        assert not res.x[:, 1].any() and float(res.resnorm[1]) == 0.0


def test_cg_solve_all_zero_rhs_exits_at_once():
    res = est.cg_solve(torch.from_numpy(_spd(10)), torch.zeros(10, 2,
                                                              dtype=torch.float64),
                       x0=torch.ones(10, 2, dtype=torch.float64),
                       device="cpu")
    assert res.iters == 0 and bool(res.converged) and not res.x.any()


def test_cg_solve_rejects_mismatched_rhs():
    with pytest.raises(ValueError, match="rhs rows"):
        est.cg_solve(torch.eye(4, dtype=torch.float64),
                     torch.ones(5, 1, dtype=torch.float64), device="cpu")


# ------------------------------------------------------------- operators

@pytest.mark.parametrize("offsets,n", [((-1, 0, 1), 9), ((-4, 0, 2, 5), 13),
                                       ((0,), 1), ((-2, 3), 7)])
def test_stencil_operator_matches_jax(offsets, n):
    rng = np.random.default_rng(9)
    bands = rng.standard_normal((len(offsets), n))
    op = est.StencilOperator(offsets, torch.from_numpy(bands))
    jop = jest.StencilOperator(offsets, jnp.asarray(bands))
    np.testing.assert_allclose(op.to_dense().numpy(),
                               np.asarray(jop.to_dense()), rtol=1e-12)
    v = rng.standard_normal((n, 4))
    for m in ("mm", "rmm"):
        np.testing.assert_allclose(
            getattr(op, m)(torch.from_numpy(v)).numpy(),
            np.asarray(getattr(jop, m)(jnp.asarray(v))), rtol=1e-12,
            atol=1e-12)
    np.testing.assert_allclose(op.mv(torch.from_numpy(v[:, 0])).numpy(),
                               np.asarray(jop.mv(jnp.asarray(v[:, 0]))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(op.diag().numpy(), np.asarray(jop.diag()))
    np.testing.assert_array_equal(
        _transpose_bands(op.bands, offsets).numpy(),
        np.asarray(jop._bands_t if jop._bands_t is not None else
                   __import__("repro.estimators.operators.stencil",
                              fromlist=["_"])._transpose_bands(
                                  jnp.asarray(bands), offsets)))
    assert op.plan_hints() == tuple(jop.plan_hints())


def test_stencil_operator_constant_bands_and_errors():
    op = est.StencilOperator((-1, 0, 1), torch.tensor([-1.0, 2.5, -1.0]),
                             n=6)
    jop = jest.StencilOperator((-1, 0, 1), jnp.asarray([-1.0, 2.5, -1.0]),
                               n=6)
    np.testing.assert_array_equal(op.to_dense().numpy(),
                                  np.asarray(jop.to_dense()))
    assert op.bands.is_contiguous()
    assert float(op.trace_hint()) == 15.0
    with pytest.raises(ValueError, match="duplicate"):
        est.StencilOperator((0, 0), torch.ones(2, 3))
    with pytest.raises(ValueError, match="require n"):
        est.StencilOperator((0,), torch.ones(1))
    with pytest.raises(ValueError, match="out of range"):
        est.StencilOperator((0, 3), torch.ones(2, 3))
    with pytest.raises(ValueError, match="band rows"):
        est.StencilOperator((0, 1), torch.ones(3, 3))
    with pytest.raises(ValueError, match="slab"):
        op.mm(torch.ones(5, 1))


def test_operator_to_leaves_the_original_alone():
    bands = torch.ones(1, 4)
    op = est.StencilOperator((0,), bands)
    moved = op.to("cpu")
    assert moved is not op and moved.device == op.device
    d = est.DenseOperator(torch.eye(3))
    assert d.to("cpu").a.device.type == "cpu" and d.to("cpu") is not d


def test_dense_operator_surface():
    a = torch.from_numpy(_spd(5))
    op = est.as_operator(a)
    assert isinstance(op, est.DenseOperator) and est.is_operator(op)
    assert not est.is_operator(a)
    v = torch.ones(5, 2, dtype=a.dtype)
    assert torch.equal(op.mm(v), a @ v) and torch.equal(op.rmm(v), a.T @ v)
    assert torch.equal(op.diag(), torch.diagonal(a))
    assert float(op.trace_hint()) == float(torch.trace(a))
    assert op.plan_hints().structure == "dense"
    assert est.as_operator(op) is op


@pytest.mark.parametrize("name,exc,match", [
    # ported: it takes a (B, n, n) stack, not one matrix
    ("BatchedOperator", ValueError, r"\(B, n, n\) stack")])
def test_unported_backends_raise(name, exc, match):
    with pytest.raises(exc, match=match):
        getattr(est, name)(torch.eye(2))


@pytest.mark.parametrize("name", ["KroneckerOperator", "ToeplitzOperator"])
def test_structured_backends_construct(name):
    """Ported (tests/test_torch_structured.py holds them against the JAX
    package): each builds from tensors, and its dense form is the
    operator's."""
    if name == "KroneckerOperator":
        a = torch.tensor([[2.0, 1.0], [0.0, 3.0]], dtype=torch.float64)
        op = est.KroneckerOperator(a, torch.eye(3, dtype=torch.float64))
        want = torch.kron(a, torch.eye(3, dtype=torch.float64))
    else:
        c = torch.tensor([2.0, 0.5, 0.25], dtype=torch.float64)
        op = est.ToeplitzOperator(c)
        want = torch.tensor([[2.0, 0.5, 0.25], [0.5, 2.0, 0.5],
                             [0.25, 0.5, 2.0]], dtype=torch.float64)
    assert est.is_operator(op) and op.shape == tuple(want.shape)
    assert torch.equal(op.to_dense(), want)
    v = torch.arange(want.shape[0] * 2, dtype=torch.float64).reshape(-1, 2)
    assert torch.allclose(op.mm(v), want @ v, rtol=1e-14, atol=1e-14)


def test_as_operator_rejects_stacks_and_shards_on_a_mesh():
    """A stack becomes a `BatchedOperator` (with or without a mesh); with a
    mesh of more than one rank a matrix becomes a `ShardedOperator` of
    this rank's rows, and with one rank a `DenseOperator`, as in the JAX
    package (the sharded products run in tests/test_torch_mesh.py)."""
    two = Mesh(group=None, size=2, rank=1, device=torch.device("cpu"))
    stack = torch.arange(18.0).reshape(2, 3, 3)
    for mesh in (None, two):
        op = est.as_operator(stack, mesh=mesh)
        assert isinstance(op, est.BatchedOperator)
        assert op.batch == 2 and op.shape == (3, 3) and op.stack is stack
    a = torch.arange(16.0).reshape(4, 4)
    op = est.as_operator(a, mesh=two)
    assert isinstance(op, est.ShardedOperator)
    assert torch.equal(op.local, a[2:]) and op.shape == (4, 4)
    assert op.plan_hints() == ("sharded", 16.0, True, 2)
    assert isinstance(est.operator_on(a, "cpu", mesh=two),
                      est.ShardedOperator)
    one = dataclasses.replace(two, size=1, rank=0)
    assert isinstance(est.as_operator(a, mesh=one), est.DenseOperator)
    with pytest.raises(ValueError, match="divisible"):
        est.ShardedOperator(torch.eye(5), two)
    with pytest.raises(ValueError, match="square"):
        est.ShardedOperator(torch.zeros(4, 5), two)


# ---------------------------------------------------------- dispatch

@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_estimate_logdet_draws_the_shared_probes(method):
    a = torch.from_numpy(_spd(24))
    kw = dict(num_probes=6, device="cpu")
    r1 = est.estimate_logdet(a, method=method, seed=4, **kw)
    direct = (est.logdet_chebyshev if method == "chebyshev"
              else est.logdet_slq)(a, seed=4, **kw)
    assert torch.equal(r1.est, direct.est)
    g = torch.Generator().manual_seed(4)
    probes = est.shared_probes(method, est.as_operator(a), g, kw)
    r2 = est.estimate_logdet(a, method=method, probes=probes,
                             generator=g, **kw)
    assert torch.equal(r1.est, r2.est)
    r3 = est.estimate_logdet(a, method=method, seed=5, **kw)
    assert not torch.equal(r1.est, r3.est)


def test_estimate_logdet_rejects_gradients_and_unknown_methods():
    """Gradients are no longer rejected: an input that requires one
    backpropagates (tests/test_torch_grad.py holds the values); an
    unknown method still raises."""
    a = torch.from_numpy(_spd(8)).requires_grad_()
    est.estimate_logdet(a, method="slq", device="cpu").est.backward()
    assert a.grad.shape == (8, 8) and torch.isfinite(a.grad).all()
    with pytest.raises(ValueError, match="unknown estimator"):
        est.estimate_logdet(a.detach(), method="exact", device="cpu")
    assert est.ESTIMATOR_METHODS == jest.ESTIMATOR_METHODS


# ------------------------------------------------------------ devices

_ENTRY_POINTS = {
    "cg_solve": lambda a: est.cg_solve(a, np.ones((a.shape[0], 2))),
    "logdet_chebyshev": lambda a: est.logdet_chebyshev(a, degree=4),
    "logdet_slq": lambda a: est.logdet_slq(a, num_steps=4),
    "estimate_logdet": lambda a: est.estimate_logdet(a, method="slq"),
    "hutchinson_trace": lambda a: est.hutchinson_trace(
        lambda v: torch.as_tensor(a) @ v, np.ones((a.shape[0], 2))),
    "chebyshev_coeffs_log": lambda a: est.chebyshev_coeffs_log(
        0.5, 4.0, 8, torch.float64),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """device=None is the card: without one an entry point raises and
    names the CPU opt-in, whatever device its input lies on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _ENTRY_POINTS[name](_spd(6))


def test_entry_points_move_arrays_to_the_device():
    a, b = _spd(12), np.random.default_rng(3).standard_normal((12, 2))
    res = est.cg_solve(a, b, tol=1e-12, device="cpu")
    assert res.x.device.type == "cpu" and res.x.dtype == torch.float64
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(a, b),
                               rtol=1e-9)
    v = _probes(12, 4)
    got = est.hutchinson_trace(lambda x: torch.from_numpy(a) @ x, v,
                               device="cpu")
    assert got.est.device.type == "cpu"
    assert _rel(got.est, (v * (a @ v)).sum(0).mean()) < 1e-12


def test_cg_solve_takes_a_non_contiguous_matrix():
    """A strided view (here the left half of a wider array) goes through
    the fused step like any matrix."""
    a = _spd(20, seed=4)
    wide = np.zeros((20, 40))
    wide[:, :20] = a
    view = torch.from_numpy(wide)[:, :20]
    assert not view.is_contiguous()
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 3)))
    res = est.cg_solve(view, b, tol=1e-12, device="cpu")
    want = est.cg_solve(torch.from_numpy(a), b, tol=1e-12, device="cpu")
    assert res.iters == want.iters
    np.testing.assert_allclose(res.x.numpy(), want.x.numpy(), rtol=1e-12)


class _DuckOnMeta:
    """A duck-typed operator on a device it cannot leave (no ``to``)."""
    shape, dtype, device = (4, 4), torch.float64, torch.device("meta")

    def mm(self, v):
        return v


def test_operator_that_cannot_move_raises():
    with pytest.raises(ValueError, match="no .to"):
        est.operator_on(_DuckOnMeta(), "cpu")
    with pytest.raises(ValueError, match="no .to"):
        est.cg_solve(_DuckOnMeta(), np.ones((4, 1)), device="cpu")
    op = est.StencilOperator((0,), torch.ones(1, 4))
    assert est.operator_on(op, "cpu") is op
    dense = est.operator_on(np.eye(4), "cpu")
    assert isinstance(dense, est.DenseOperator) and dense.device.type == "cpu"
