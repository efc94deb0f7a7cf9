"""The port's gradients (`repro_torch.estimators.grad`, ``plan(...)
.value_and_grad``) on the CPU, against the JAX package's (`repro
.estimators.grad`, ``jax.grad`` of ``repro.plan(...).logdet``).

The same numpy arrays, and for the estimators the same probe slabs (and
Chebyshev bounds), go through both packages; the JAX package runs as
tests/test_grad.py runs it.  The cases are that file's, without the
batched, Kronecker, Toeplitz, jit and HLO ones (not ported): exact
gradients equal ``inv(A).T`` (finite differences, non-symmetric input,
padding, n = 0, a zero gradient for the sign), estimator gradients are
the Hutchinson pullback on the forward's own probes and lie within 3 sem
of ``inv(A).T``, structured (stencil band) cotangents equal the dense
path's, and operators opt in through the registry.  The mesh routes run
on P = 1 and 2 gloo ranks (`core.mesh.run_ranks`, rank function
tests/test_torch_ranks.py:grad_routes), the JAX references at P = 1 in
this process and at P = 2 in a subprocess with two fake devices.

Also pinned: the fault this port had before its gradients, an exact plan
building an autograd graph through the elimination (rank1 and panel
raised inside ``backward``; on the card the kernels would have cut the
graph silently).  Every exact route's ``logabsdet`` now has one backward
node, the VJP's.

Tolerances (relative to the largest entry of the reference): f64 exact
gradients 1e-10, estimator gradients 1e-8 (both packages' backward CG at
its default ``grad_cg_tol`` 1e-8), f32 1e-4.  Finite differences as in
tests/test_grad.py: central, h = 1e-5, rtol 1e-5, atol 1e-7.
"""
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro
from repro import estimators as jest
from repro.kernels.ref import stencil_mv_ref as jax_stencil_mv_ref

import test_torch_ranks as ranks
from _subproc import SRC, run_with_devices

import repro_torch
from repro_torch import estimators as est
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.mesh import run_ranks
from repro_torch.core.plan import clear_plan_cache
from repro_torch.kernels import ref

EXACT_RTOL = {"float64": 1e-10, "float32": 1e-4}
EST_RTOL = 1e-8
SPAWN_TIMEOUT = 300

# the exact routes, with the same keywords for both packages' plans
EXACT_ROUTES = {
    "serial|rank1": dict(method="exact", schedule="serial", update="rank1"),
    "staged|rank1": dict(method="exact", schedule="staged", update="rank1"),
    "serial|panel": dict(method="exact", schedule="serial", update="panel",
                         k=4),
    "staged|panel": dict(method="exact", schedule="staged", update="panel",
                         k=4),
    "staged|rank1|fused": dict(method="exact", schedule="staged",
                               update="rank1", fused=True),
    "ge": dict(method="ge"),
}
EST_ROUTES = {"chebyshev": dict(degree=48), "slq": dict(num_steps=20)}


def make_spd(n, seed, shift=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + shift * np.eye(n)


def make_nonsym(n, seed):
    """Well-conditioned non-symmetric matrix (diagonally dominated)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) * 0.3 + 2.0 * np.eye(n)


def rademacher(n, k, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((n, k)) < 0.5, -1.0, 1.0)


def assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rtol * scale, (err, rtol * scale)


def port_grad(a: np.ndarray, dtype=torch.float64, **kw):
    """(autograd gradient, logabsdet tensor) of a port plan on the CPU."""
    x = torch.from_numpy(a).to(dtype).requires_grad_()
    ld = repro_torch.plan(x.detach(), device="cpu", **kw).logdet(x)
    ld.backward()
    return x.grad, ld


def jax_grad(a: np.ndarray, **kw):
    p = repro.plan(jnp.asarray(a), **kw)
    return np.asarray(jax.grad(p.logdet)(jnp.asarray(a)))


@pytest.fixture(autouse=True)
def _fresh_plans():
    clear_plan_cache()
    yield
    clear_plan_cache()


# ------------------------------------------------------------ exact methods

@pytest.mark.parametrize("n", [4, 16, 33])
@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_exact_gradcheck_fd(route, n):
    """Finite-difference check at N in {4, 16, 33} (33 is padded inside
    the panel routes)."""
    a = make_spd(n, seed=n)
    g, _ = port_grad(a, **EXACT_ROUTES[route])
    p = repro_torch.plan(a, device="cpu", **EXACT_ROUTES[route])
    rng = np.random.default_rng(7)
    h = 1e-5
    for _ in range(3):
        d = rng.standard_normal((n, n))
        want = (float(p.logdet(torch.from_numpy(a + h * d)))
                - float(p.logdet(torch.from_numpy(a - h * d)))) / (2 * h)
        got = float((g.numpy() * d).sum())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["spd", "nonsym"])
@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_exact_grad_matches_jax_and_inverse(route, case):
    """d log|det A| / dA = A^{-T}, for general (non-SPD) matrices too, and
    equal to ``jax.grad`` of the same JAX route."""
    a = make_spd(24, 3) if case == "spd" else make_nonsym(20, 5)
    g, _ = port_grad(a, **EXACT_ROUTES[route])
    assert_close(g, np.linalg.inv(a).T, EXACT_RTOL["float64"])
    assert_close(g, jax_grad(a, **EXACT_ROUTES[route]), EXACT_RTOL["float64"])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_exact_logabsdet_has_one_backward_node(route, dtype):
    """The repaired fault: no graph through the elimination.  The only
    backward node is the VJP's, straight onto the input, and the
    gradient is inv(A)^T (rank1 and panel used to raise inside
    ``backward``)."""
    a = make_nonsym(18, 2)
    g, ld = port_grad(a, getattr(torch, dtype), **EXACT_ROUTES[route])
    node = ld.grad_fn
    assert node.name() == "_ExactSlogdetBackward"
    nexts = [f for f, _ in node.next_functions if f is not None]
    assert [f.name() for f in nexts] == ["torch::autograd::AccumulateGrad"]
    assert g.dtype == getattr(torch, dtype)
    assert_close(g, np.linalg.inv(a).T, EXACT_RTOL[dtype])


def test_exact_sign_has_zero_grad():
    """The sign is piecewise constant: not differentiable in the port,
    a zero gradient in the JAX package."""
    a = make_nonsym(8, 0)
    x = torch.from_numpy(a).requires_grad_()
    res = repro_torch.plan(a, method="exact", device="cpu")(x)
    assert not res.sign.requires_grad and res.logabsdet.requires_grad
    (res.sign * 3.0 + res.logabsdet).backward()
    assert_close(x.grad, np.linalg.inv(a).T, EXACT_RTOL["float64"])
    jp = repro.plan(jnp.asarray(a), method="exact")
    gj = jax.grad(lambda y: jp.slogdet(y)[0])(jnp.asarray(a))
    np.testing.assert_array_equal(np.asarray(gj), 0.0)


@pytest.mark.parametrize("update", ["rank1", "panel"])
def test_exact_grad_through_padding(update):
    """Padding inside the plan (panel K = 8 on N = 10) and in front of it
    (`pad_to_multiple`, diag(A, I)) leave the gradient of A's block
    unchanged."""
    a = make_spd(10, 2)
    kw = dict(method="exact", update=update, k=8)
    g_plain, _ = port_grad(a, **kw)
    x = torch.from_numpy(a).requires_grad_()
    p = repro_torch.plan(np.eye(16), device="cpu", **kw)
    p.logdet(pad_to_multiple(x, 8)).backward()
    assert_close(x.grad, g_plain, EXACT_RTOL["float64"])
    assert_close(g_plain, np.linalg.inv(a).T, EXACT_RTOL["float64"])


@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_exact_grad_at_n0(route):
    """n = 0: log|det| 0 and an empty gradient, from autograd and from
    value_and_grad, as in the JAX package."""
    g, ld = port_grad(np.zeros((0, 0)), **EXACT_ROUTES[route])
    assert float(ld.detach()) == 0.0 and g.shape == (0, 0)
    res, g2 = repro_torch.plan(np.zeros((0, 0)), device="cpu",
                               **EXACT_ROUTES[route]).value_and_grad()
    assert float(res.logabsdet) == 0.0 and g2.shape == (0, 0)
    assert jax_grad(np.zeros((0, 0)), **EXACT_ROUTES[route]).shape == (0, 0)


@pytest.mark.parametrize("route", sorted(EXACT_ROUTES))
def test_exact_value_and_grad(route):
    """value_and_grad: the plan's own forward (bitwise ``__call__``'s) and
    inv(A)^T, bitwise equal to the autograd path's (g = 1), equal to
    the JAX plan's value_and_grad; no CG, so no cg_iters."""
    a = make_nonsym(21, 4)
    p = repro_torch.plan(a, device="cpu", **EXACT_ROUTES[route])
    res, g = p.value_and_grad()
    call = p()
    assert torch.equal(res.sign, call.sign)
    assert torch.equal(res.logabsdet, call.logabsdet)
    assert not g.requires_grad and not res.logabsdet.requires_grad
    assert res.diagnostics.cg_iters is None
    assert res.diagnostics.wall_time_s > 0
    g_auto, _ = port_grad(a, **EXACT_ROUTES[route])
    assert torch.equal(g, g_auto)
    jres, jg = repro.plan(jnp.asarray(a), **EXACT_ROUTES[route]) \
        .value_and_grad()
    assert float(res.sign) == float(jres.sign)
    assert_close(float(res.logabsdet), float(jres.logabsdet), 1e-12)
    assert_close(g, np.asarray(jg), EXACT_RTOL["float64"])


def test_exact_value_and_grad_rejects_estimator_inputs():
    p = repro_torch.plan(make_spd(6, 0), method="exact", device="cpu")
    with pytest.raises(TypeError, match="no generator"):
        p.value_and_grad(generator=torch.Generator())


# -------------------------------------- which linear algebra a backward runs

_FACTORIZATIONS = ("inv", "inv_ex", "solve", "lu_factor", "lu_factor_ex",
                   "cholesky", "solve_triangular")


def _count_factorizations(monkeypatch):
    calls = dict.fromkeys(_FACTORIZATIONS, 0)
    for name in _FACTORIZATIONS:
        fn = getattr(torch.linalg, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(torch.linalg, name, counted)
    return calls


@pytest.mark.parametrize("method,kw", [("chebyshev", dict(degree=16)),
                                       ("slq", dict(num_steps=10))])
def test_estimator_backward_has_no_dense_solve(monkeypatch, method, kw):
    """The estimator backward is matrix-free: no inverse, solve or
    factorization is called (the intent of the JAX package's HLO pass)."""
    a = make_spd(16, 0)
    x = torch.from_numpy(a).requires_grad_()
    ld = repro_torch.plan(a, method=method, num_probes=8, device="cpu",
                          **kw).logdet(x)
    calls = _count_factorizations(monkeypatch)
    ld.backward()
    assert sum(calls.values()) == 0, calls
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("route", ["staged|panel", "ge"])
def test_exact_backward_does_use_factorization(monkeypatch, route):
    """The contrast case, and the counter's proof: the exact backward
    inverts once (`torch.linalg.inv_ex`, which returns inf/NaN on a
    singular matrix where `inv` raises) and does nothing else."""
    a = make_spd(16, 0)
    x = torch.from_numpy(a).requires_grad_()
    ld = repro_torch.plan(a, device="cpu", **EXACT_ROUTES[route]).logdet(x)
    calls = _count_factorizations(monkeypatch)
    ld.backward()
    assert calls == {**dict.fromkeys(_FACTORIZATIONS, 0), "inv_ex": 1}


# ------------------------------------------ estimators: Hutchinson pullback

def _est_grads(method, a, z, bounds=(1.0, 8.0), **kw):
    """The port's and the JAX package's estimator gradients on probes z
    (Chebyshev on the same bounds)."""
    kw = dict(kw, **EST_ROUTES[method])
    if method == "chebyshev":
        kw.update(lmin=bounds[0], lmax=bounds[1])
    x = torch.from_numpy(a).requires_grad_()
    res = est.estimate_logdet(x, method=method, probes=torch.from_numpy(z),
                              device="cpu", **kw)
    res.est.backward()
    gj = jax.grad(lambda y: jest.estimate_logdet(
        y, method=method, probes=jnp.asarray(z), **kw).est)(jnp.asarray(a))
    return x.grad.numpy(), np.asarray(gj), res


@pytest.mark.parametrize("method", sorted(EST_ROUTES))
def test_estimator_grad_is_hutchinson_pullback(method):
    """The gradient is (1/k) sum_c (A^{-1} z_c) z_c^T on the forward's
    own probes, up to the backward CG tolerance, as in JAX."""
    n, k = 32, 64
    a = make_spd(n, 0)
    z = rademacher(n, k, 3)
    g, gj, _ = _est_grads(method, a, z)
    bar = (np.linalg.solve(a, z) @ z.T) / k
    np.testing.assert_allclose(g, bar, rtol=1e-6, atol=1e-7)
    assert_close(g, gj, EST_RTOL)


@pytest.mark.parametrize("method", sorted(EST_ROUTES))
def test_estimator_grad_within_3sem_of_exact(method):
    n, k = 32, 64
    a = make_spd(n, 0)
    z = rademacher(n, k, 3)
    g, _, _ = _est_grads(method, a, z)
    samples = np.einsum("ik,jk->ijk", np.linalg.solve(a, z), z)
    sem = samples.std(-1, ddof=1) / np.sqrt(k)
    err = np.linalg.norm(g - np.linalg.inv(a).T)
    assert err <= 3.0 * np.sqrt((sem ** 2).sum()), err


@pytest.mark.parametrize("method", sorted(EST_ROUTES))
def test_estimator_forward_value_unchanged_by_grad_path(method):
    """estimate_logdet on an input that requires a gradient gives the
    bits of the same call without one, and of the estimator called
    directly."""
    a = make_spd(48, 4)
    direct_fn = {"chebyshev": est.logdet_chebyshev,
                 "slq": est.logdet_slq}[method]
    direct = direct_fn(torch.from_numpy(a), num_probes=16, seed=9,
                       device="cpu")
    plain = est.estimate_logdet(torch.from_numpy(a), method=method,
                                num_probes=16, seed=9, device="cpu")
    x = torch.from_numpy(a).requires_grad_()
    routed = est.estimate_logdet(x, method=method, num_probes=16, seed=9,
                                 device="cpu")
    assert routed.est.requires_grad and not plain.est.requires_grad
    for r in (plain, routed):
        assert torch.equal(r.est, direct.est)
        assert torch.equal(r.sem, direct.sem)
        assert torch.equal(r.samples, direct.samples)


def test_estimator_sem_and_samples_nondifferentiable():
    x = torch.from_numpy(make_spd(16, 1)).requires_grad_()
    res = est.estimate_logdet(x, num_probes=8, degree=16, device="cpu")
    assert res.est.requires_grad
    assert not res.sem.requires_grad and not res.samples.requires_grad
    gj = jax.grad(lambda y: jest.estimate_logdet(
        y, num_probes=8, degree=16).sem)(jnp.asarray(make_spd(16, 1)))
    np.testing.assert_array_equal(np.asarray(gj), 0.0)


def test_estimator_grad_cg_knobs():
    """grad_cg_tol / grad_cg_maxiter reach the backward solve, through
    the plan's config as through estimate_logdet."""
    a = make_spd(24, 2)

    def grad(**knobs):
        x = torch.from_numpy(a).requires_grad_()
        repro_torch.plan(a, method="chebyshev", num_probes=8, degree=16,
                         device="cpu", **knobs).logdet(x).backward()
        return x.grad

    loose, tight = grad(grad_cg_tol=1e-2), grad(grad_cg_tol=1e-12)
    assert torch.isfinite(loose).all() and torch.isfinite(tight).all()
    assert float((loose - tight).abs().max()) > 0.0
    one = grad(grad_cg_maxiter=1)
    assert float((one - tight).abs().max()) > 1e-6
    p = repro_torch.plan(a, method="slq", num_probes=8, num_steps=8,
                         device="cpu", grad_cg_maxiter=2)
    assert p.value_and_grad()[0].diagnostics.cg_iters == 2
    assert repro_torch.plan(
        a, method="slq", num_probes=8, num_steps=8, device="cpu",
        grad_cg_tol=1e-12).value_and_grad()[0].diagnostics.cg_iters > 2


@pytest.mark.parametrize("method", sorted(EST_ROUTES))
def test_estimator_value_and_grad(method):
    """value_and_grad draws the probes as ``__call__`` does: the value is
    bitwise ``__call__``'s and the gradient bitwise the autograd path's
    with the same generator; cg_iters counts the backward solve."""
    a = make_spd(20, 6)
    p = repro_torch.plan(a, method=method, num_probes=8, device="cpu",
                         **EST_ROUTES[method])
    res, g = p.value_and_grad(generator=torch.Generator().manual_seed(5))
    call = p(generator=torch.Generator().manual_seed(5))
    assert torch.equal(res.logabsdet, call.logabsdet)
    assert torch.equal(res.sem, call.sem)
    x = torch.from_numpy(a).requires_grad_()
    p.logdet(x, generator=torch.Generator().manual_seed(5)).backward()
    assert torch.equal(g, x.grad)
    assert res.diagnostics.cg_iters > 0 and call.diagnostics.cg_iters is None
    # the config's seed when no generator is given
    res0, g0 = p.value_and_grad()
    assert torch.equal(res0.logabsdet, p().logabsdet)


def test_grad_plan_builds_value_and_grad():
    """plan(grad=True) builds the callable with the plan, on a cache hit
    too; a plan without it builds it at the first call."""
    a = make_spd(12, 1)
    p = repro_torch.plan(a, method="slq", device="cpu", num_probes=4)
    assert not p.grad and "vag" not in p._cache
    q = repro_torch.plan(a, method="slq", device="cpu", num_probes=4,
                         grad=True)
    assert q.grad and "vag" in q._cache and q._cache is p._cache
    r = repro_torch.plan(make_spd(12, 2), method="exact", device="cpu",
                         grad=True)
    assert r.grad and "vag" in r._cache
    s = repro_torch.plan(make_spd(12, 3), method="ge", device="cpu")
    s.value_and_grad()
    assert "vag" in s._cache


def test_hutchinson_pullback_matches_jax():
    """The pullback called directly, dense registration: (g/k) W Z^T and
    the transposed CG's iterations, against the JAX function on the same
    probes."""
    a = make_nonsym(24, 1) + 2.0 * np.eye(24)
    a = a @ a.T / 24 + np.eye(24)
    z = rademacher(24, 12, 0)
    op = est.DenseOperator(torch.from_numpy(a))
    bar, cg = est.hutchinson_pullback(op, op.a, torch.from_numpy(z), 2.0)
    jop = jest.DenseOperator(jnp.asarray(a))
    jbar, jcg = jest.hutchinson_pullback(jop, jop.a, jnp.asarray(z), 2.0)
    assert_close(bar, np.asarray(jbar), EST_RTOL)
    assert cg.iters == int(jcg.iters)
    assert_close(bar, 2.0 * np.linalg.solve(a.T, z) @ z.T / 12, 1e-7)
    with pytest.raises(TypeError, match="registration"):
        est.hutchinson_pullback(object(), None, torch.from_numpy(z), 1.0)


# ------------------------------------------- structured operator pullbacks

EST_KW = dict(method="slq", num_probes=16, num_steps=20)


def _tridiag_bands(n):
    return np.stack([np.full(n, -1.0), np.full(n, 2.5), np.full(n, -1.0)])


def _stencil_dense(bands, n):
    """offsets (-1, 0, 1) materialized with differentiable ops, matching
    StencilOperator.to_dense."""
    return (torch.diag(bands[1]) + torch.diag(bands[2][:n - 1], 1)
            + torch.diag(bands[0][1:], -1))


def _stencil_grad(bands, z, offsets=(-1, 0, 1)):
    b = torch.from_numpy(bands).requires_grad_()
    res = est.estimate_logdet(est.StencilOperator(offsets, b),
                              probes=torch.from_numpy(z), device="cpu",
                              **EST_KW)
    res.est.backward()
    return b.grad


def test_stencil_pullback_band_shaped():
    n = 24
    g = _stencil_grad(_tridiag_bands(n), rademacher(n, 16, 5))
    assert g.shape == (3, n) and torch.isfinite(g).all()


def test_stencil_pullback_matches_dense_path_and_jax():
    """The band cotangent equals the dense path's chained through the
    materialization, and the JAX package's structured one."""
    n = 24
    bands = _tridiag_bands(n)
    z = rademacher(n, 16, 5)
    g_struct = _stencil_grad(bands, z)
    b = torch.from_numpy(bands).requires_grad_()
    est.estimate_logdet(_stencil_dense(b, n), probes=torch.from_numpy(z),
                        device="cpu", **EST_KW).est.backward()
    assert_close(g_struct, b.grad, 1e-7)
    gj = jax.grad(lambda bb: jest.estimate_logdet(
        jest.StencilOperator((-1, 0, 1), bb), probes=jnp.asarray(z),
        **EST_KW).est)(jnp.asarray(bands))
    assert_close(g_struct, np.asarray(gj), EST_RTOL)


def test_stencil_constant_bands_grad_flows_through_expand():
    """A (nb,) constant-band input: its gradient is the band gradient
    summed along each diagonal, through the ``expand`` of the operator."""
    n = 24
    z = rademacher(n, 16, 5)
    c = torch.tensor([-1.0, 2.5, -1.0], dtype=torch.float64,
                     requires_grad=True)
    est.estimate_logdet(est.StencilOperator((-1, 0, 1), c, n=n),
                        probes=torch.from_numpy(z), device="cpu",
                        **EST_KW).est.backward()
    g_full = _stencil_grad(_tridiag_bands(n), z)
    assert c.grad.shape == (3,)
    assert_close(c.grad, g_full.sum(1), 1e-12)


def test_stencil_plan_value_and_grad():
    """A stencil plan's value_and_grad is band-shaped, equal to the
    autograd path through ``plan(op).logdet()`` with the same generator,
    and within 3 sem of inv(A)^T read off the bands' positions."""
    side = 6
    n = side * side
    i = np.arange(n)
    bands = np.full((5, n), -1.0)
    bands[2] = 4.1
    bands[1][i % side == 0] = 0.0
    bands[3][i % side == side - 1] = 0.0
    offsets = (-side, -1, 0, 1, side)
    b = torch.from_numpy(bands).requires_grad_()
    op = est.StencilOperator(offsets, b)
    p = repro_torch.plan(op, method="slq", num_probes=64, device="cpu")
    res, g = p.value_and_grad(generator=torch.Generator().manual_seed(1))
    p.logdet(generator=torch.Generator().manual_seed(1)).backward()
    assert g.shape == (5, n) and torch.equal(g, b.grad)
    assert res.diagnostics.cg_iters > 0
    inv_t = np.linalg.inv(op.to_dense().detach().numpy()).T
    want = np.zeros_like(bands)
    for d, off in enumerate(offsets):
        rows = i[(i + off >= 0) & (i + off < n)]
        want[d, rows] = inv_t[rows, rows + off]
    # per-entry sample variance of w[i, c] z[i + off, c] (z^2 = 1)
    z = est.shared_probes("slq", op, torch.Generator().manual_seed(1),
                          {"num_probes": 64})
    _, cg = est.hutchinson_pullback(op, op.bands.detach(), z, 1.0)
    w2 = (cg.x.numpy() ** 2).sum(1)
    k = 64
    var = np.zeros_like(bands)
    for d, off in enumerate(offsets):
        rows = i[(i + off >= 0) & (i + off < n)]
        var[d, rows] = (w2[rows] - k * g.numpy()[d, rows] ** 2) / (k - 1)
    err = np.linalg.norm(g.numpy() - want)
    assert err <= 3.0 * np.sqrt((var / k).sum()), err


@pytest.mark.parametrize("offsets", [(-1, 0, 1), (-5, -1, 0, 3),
                                     (2, 7), (-6, 0, 6)])
def test_stencil_apply_backward(offsets):
    """The stencil's ``apply``: its forward is `ops.stencil_mv`, and its
    closed-form backward (bands and z) equals autograd of
    `ref.stencil_mv_ref` and the JAX package's ``jax.vjp`` of its
    `stencil_mv_ref`, in f64."""
    n, k = 17, 5
    rng = np.random.default_rng(len(offsets))
    bands = rng.standard_normal((len(offsets), n))
    z = rng.standard_normal((n, k))
    w = rng.standard_normal((n, k))
    op = est.StencilOperator(offsets, torch.from_numpy(bands))
    bt = torch.from_numpy(bands).requires_grad_()
    zt = torch.from_numpy(z).requires_grad_()
    y = est.stencil_apply(op, bt, zt)
    (y * torch.from_numpy(w)).sum().backward()
    b2 = torch.from_numpy(bands).requires_grad_()
    z2 = torch.from_numpy(z).requires_grad_()
    y2 = ref.stencil_mv_ref(b2, z2, offsets=offsets)
    (y2 * torch.from_numpy(w)).sum().backward()
    assert torch.equal(y, y2)
    assert_close(bt.grad, b2.grad, 1e-14)
    assert_close(zt.grad, z2.grad, 1e-14)
    _, pull = jax.vjp(lambda bb, zz: jax_stencil_mv_ref(bb, zz,
                                                        offsets=offsets),
                      jnp.asarray(bands), jnp.asarray(z))
    jb, jz = pull(jnp.asarray(w))
    assert_close(bt.grad, np.asarray(jb), 1e-14)
    assert_close(zt.grad, np.asarray(jz), 1e-14)


def test_register_operator_grad_duck_type():
    """A duck-typed operator opts into gradients through the registry,
    with the JAX package's fields."""

    class ScaledIdentity(est.LinearOperator):
        def __init__(self, s, n):
            self.s = s
            self.shape = (n, n)
            self.dtype = s.dtype

        def mm(self, v):
            return self.s * v

        def diag(self):
            return self.s.expand(self.n)

    est.register_operator_grad(
        ScaledIdentity,
        params=lambda op: op.s,
        rebuild=lambda op, s: ScaledIdentity(s, op.n))
    n = 16
    s = torch.tensor(3.0, dtype=torch.float64, requires_grad=True)
    assert est.operator_grad_info(ScaledIdentity(s, n)) is not None
    res = est.estimate_logdet(ScaledIdentity(s, n), method="slq",
                              num_probes=8, num_steps=8, device="cpu")
    res.est.backward()
    # logdet(s I_n) = n log s  ->  d/ds = n / s (quadrature exact for c*I)
    np.testing.assert_allclose(float(s.grad), n / 3.0, rtol=1e-8)
    assert float(res.est.detach()) == pytest.approx(n * np.log(3.0),
                                                  rel=1e-12)


def test_unregistered_duck_operator_still_estimates():
    """No registration: the plain forward runs (as in JAX), and autograd
    sees the operator's own products."""

    class Duck:
        def __init__(self, a):
            self.a = a
            self.shape = tuple(a.shape)
            self.dtype = a.dtype

        def mm(self, v):
            return self.a @ v

    a = make_spd(24, 6)
    assert est.operator_grad_info(Duck(torch.from_numpy(a))) is None
    res = est.estimate_logdet(Duck(torch.from_numpy(a)), method="chebyshev",
                              num_probes=32, degree=48, seed=0,
                              device="cpu")
    ref_ld = np.linalg.slogdet(a)[1]
    assert abs(float(res.est) - ref_ld) / abs(ref_ld) < 0.05
    with pytest.raises(TypeError, match="registration"):
        repro_torch.plan(Duck(torch.from_numpy(a)), method="slq",
                         device="cpu").value_and_grad()


@pytest.mark.parametrize("structure", ["dense", "stencil"])
def test_cg_transpose_solves_transposed_system(structure):
    """cg_solve(..., transpose=True) -- the backward's solve -- applies
    A^T through rmm, as in JAX."""
    n = 16
    rng = np.random.default_rng(0)
    if structure == "dense":
        op = est.DenseOperator(torch.from_numpy(make_spd(n, 0)))
    else:
        op = est.StencilOperator((-1, 0, 1), torch.tensor([-1.0, 2.5, -1.0],
                                 dtype=torch.float64), n=n)
    dense = op.to_dense().numpy()
    b = rng.standard_normal((n, 3))
    res = est.cg_solve(op, torch.from_numpy(b), transpose=True, tol=1e-12,
                       device="cpu")
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(dense.T, b),
                               rtol=1e-8, atol=1e-8)


# --------------------------------------------------------------- the mesh

MESH_N, MESH_SPD_N, MESH_K, NBS = 37, 13, 16, (1, 3)
MESH_A = make_nonsym(MESH_N, 11)
MESH_SPD = make_spd(MESH_SPD_N, 12)
# rows for the largest padded side (14 at P = 2)
MESH_PROBES = rademacher(14, MESH_K, 13)
MESH_BOUNDS = (1.5, 5.0)
MESH_ROUTES = [*(f"exact|{u}|{la}" for u in ("rank1", "panel")
                 for la in (0, 1)), "pge", *(f"plu{nb}" for nb in NBS)]


def _jax_mesh_kw(route):
    if route.startswith("exact"):
        _, update, la = route.split("|")
        return dict(method="exact", update=update, k=ranks.PANEL_K,
                    lookahead=bool(int(la)))
    if route == "pge":
        return dict(method="pge")
    return dict(method="plu", nb=int(route[3:]))


def _jax_mesh_est_kw(method):
    if method == "chebyshev":
        return dict(method=method, degree=16, lmin=MESH_BOUNDS[0],
                    lmax=MESH_BOUNDS[1])
    return dict(method=method, num_steps=12)


def _jax_mesh_grads(mesh):
    """The JAX package's gradients of every mesh route on ``mesh``."""
    out = {}
    a = jnp.asarray(MESH_A)
    for route in MESH_ROUTES:
        p = repro.plan(a, mesh=mesh, **_jax_mesh_kw(route))
        out[route] = np.asarray(jax.grad(p.logdet)(a))
    s = jnp.asarray(MESH_SPD)
    for method in ("chebyshev", "slq"):
        p = repro.plan(s, mesh=mesh, num_probes=MESH_K,
                       **_jax_mesh_est_kw(method))
        z = jnp.asarray(MESH_PROBES[:p.diagnostics.padded_n])
        out[method] = np.asarray(
            jax.grad(lambda y: p.logdet(y, probes=z))(s))
    return out


_JAX_MESH_CODE = """
import sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import repro
from repro._compat import make_mesh
import test_torch_grad as T
out = T._jax_mesh_grads(make_mesh((2,), ("rows",)))
np.savez({path!r}, **out)
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    from repro._compat import make_mesh
    refs = {1: _jax_mesh_grads(make_mesh((1,), ("rows",)))}
    path = str(tmp_path_factory.mktemp("jax_grad") / "p2.npz")
    tests = str(pathlib.Path(__file__).resolve().parent)
    run_with_devices(_JAX_MESH_CODE.format(src=SRC, tests=tests, path=path),
                     2, timeout=SPAWN_TIMEOUT)
    with np.load(path) as data:
        refs[2] = {k: data[k] for k in data.files}
    return refs


_PORT_MESH: dict = {}


def _port_mesh(size: int) -> list:
    """Every rank's `ranks.grad_routes` for mesh size ``size`` (one
    spawn)."""
    if size not in _PORT_MESH:
        _PORT_MESH[size] = run_ranks(
            ranks.grad_routes, size, backend="gloo", device="cpu",
            timeout=SPAWN_TIMEOUT,
            args=(MESH_A, MESH_SPD, MESH_PROBES, MESH_BOUNDS, NBS))
    return _PORT_MESH[size]


@pytest.mark.parametrize("route", MESH_ROUTES)
@pytest.mark.parametrize("size", [1, 2])
def test_mesh_exact_grad_matches_jax(jax_mesh, size, route):
    """Exact mesh routes, pge and plu: the autograd gradient through the
    VJP node is inv(A)^T, bitwise value_and_grad's, and the JAX mesh
    route's; the value is value_and_grad's."""
    ld, g, node, vld, vg = _port_mesh(size)[0][route]
    assert node == "_ExactSlogdetBackward"
    assert ld == vld and np.array_equal(g, vg)
    assert_close(g, np.linalg.inv(MESH_A).T, EXACT_RTOL["float64"])
    assert_close(g, jax_mesh[size][route], EXACT_RTOL["float64"])


@pytest.mark.parametrize("method", ["chebyshev", "slq"])
@pytest.mark.parametrize("size", [1, 2])
def test_mesh_estimator_grad_matches_jax_and_dense(jax_mesh, size, method):
    """Sharded estimators (N = 13, padded to 14 on two ranks): the
    gradient on the probes equals the JAX mesh route's and the port's
    dense one; value_and_grad's value is ``__call__``'s."""
    ld, g, vld, vg, iters, call_ld = _port_mesh(size)[0][method]
    assert g.shape == vg.shape == (MESH_SPD_N, MESH_SPD_N)
    assert vld == call_ld and iters > 0
    assert_close(g, jax_mesh[size][method], EST_RTOL)
    padded = -(-MESH_SPD_N // size) * size
    kw = _jax_mesh_est_kw(method)
    kw.pop("method")
    if padded != MESH_SPD_N and method == "chebyshev":
        kw.update(lmin=min(kw["lmin"], 1.0), lmax=max(kw["lmax"], 1.0))
    x = torch.from_numpy(MESH_SPD).requires_grad_()
    z = torch.from_numpy(MESH_PROBES[:padded])
    est.estimate_logdet(pad_to_multiple(x, size), method=method, probes=z,
                        device="cpu", **kw).est.backward()
    assert_close(g, x.grad, EST_RTOL)


@pytest.mark.parametrize("size", [1, 2])
def test_mesh_every_rank_has_the_same_grad(size):
    results = _port_mesh(size)
    for res in results[1:]:
        for route, fields in res.items():
            for got, want in zip(fields, results[0][route]):
                assert np.array_equal(np.asarray(got), np.asarray(want)), \
                    route


def test_mesh_value_and_grad_is_each_rank_s_own_inverse():
    """One rank's full-matrix inverse is the same bits as the serial
    plan's: no collective enters the exact backward."""
    g_serial = repro_torch.plan(MESH_A, method="exact", device="cpu") \
        .value_and_grad()[1].numpy()
    for size in (1, 2):
        for route in MESH_ROUTES:
            assert np.array_equal(_port_mesh(size)[0][route][4], g_serial)

