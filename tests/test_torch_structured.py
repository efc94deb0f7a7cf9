"""The port's structured operators (`KroneckerOperator`, `ToeplitzOperator`)
and the `gmm_loglik.py` twin, on the CPU, against the JAX package.

The same numpy arrays go through `repro.estimators.operators` and
`repro_torch.estimators.operators`: Kronecker with nA = 7, nB = 5 (SPD
factors for the estimators, general ones for the products), Toeplitz with
n = 37, symmetric (an SPD AR(1)-like column) and non-symmetric.  Every
method (`mm`, `rmm`, `diag`, `trace_hint`, `to_dense`, `plan_hints`), the
estimators on the same probes (Chebyshev with the same bounds), `cg_solve`
and the gradients agree within 1e-12 of the JAX package's in f64
(relative to the largest entry of the reference).  Neither operator runs a
kernel of the port in either package: their products are reshaped GEMMs
and FFTs.

`examples/gmm_loglik_torch.py` runs on the CPU: its exact/direct EM gives
the JAX example's printed log-likelihoods, and its slq/cg run agrees with
the exact one within the estimators' standard errors.
"""
import importlib.util
import io
import pathlib
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro.estimators import operators as jops
from repro.estimators import estimate_logdet as jax_estimate_logdet
from repro.estimators import cg_solve as jax_cg_solve

import repro_torch
from repro_torch import estimators as est
from repro_torch.estimators import operators as tops
from repro_torch.kernels import ops

RTOL = 1e-12
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + 2.0 * np.eye(n)


def _toeplitz_cols(n=37, seed=3):
    """(c, r): a symmetric SPD first column (rho^k, rho = 0.5, plus a small
    seeded perturbation) and a non-symmetric first row."""
    rng = np.random.default_rng(seed)
    c = 0.5 ** np.arange(n) + 0.01 * rng.standard_normal(n) * 0.5 ** np.arange(n)
    c[0] = 1.5
    r = 0.4 ** np.arange(n) * (1 + 0.1 * rng.standard_normal(n))
    r[0] = c[0]
    return c, r


def _cases():
    """name -> (jax operator, port operator, spd)."""
    rng = np.random.default_rng(11)
    ka, kb = rng.standard_normal((7, 7)), rng.standard_normal((5, 5))
    sa, sb = _spd(7, 1), _spd(5, 2)
    c, r = _toeplitz_cols()
    t = torch.from_numpy
    return {
        "kron": (jops.KroneckerOperator(jnp.asarray(ka), jnp.asarray(kb)),
                 tops.KroneckerOperator(t(ka), t(kb)), False),
        "kron_spd": (jops.KroneckerOperator(jnp.asarray(sa), jnp.asarray(sb)),
                     tops.KroneckerOperator(t(sa), t(sb)), True),
        "toeplitz_sym": (jops.ToeplitzOperator(jnp.asarray(c)),
                         tops.ToeplitzOperator(t(c)), True),
        "toeplitz_nonsym": (jops.ToeplitzOperator(jnp.asarray(c),
                                                  jnp.asarray(r)),
                            tops.ToeplitzOperator(t(c), t(r)), False),
    }


CASES = ["kron", "kron_spd", "toeplitz_sym", "toeplitz_nonsym"]
SPD_CASES = ["kron_spd", "toeplitz_sym"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("method", ["mm", "rmm", "mv", "rmv"])
def test_products_match_jax(name, method):
    jop, top, _ = _cases()[name]
    v = np.random.default_rng(5).standard_normal((jop.shape[0], 4))
    if method in ("mv", "rmv"):
        v = v[:, 0]
    _close(getattr(top, method)(torch.from_numpy(v)),
           getattr(jop, method)(jnp.asarray(v)))


@pytest.mark.parametrize("name", CASES)
def test_structure_matches_jax(name):
    jop, top, _ = _cases()[name]
    _close(top.diag(), jop.diag())
    _close(top.trace_hint(), jop.trace_hint())
    _close(top.to_dense(), jop.to_dense())
    assert top.shape == tuple(jop.shape) and top.dtype == torch.float64
    assert tuple(top.plan_hints()) == tuple(jop.plan_hints())
    # the transpose is the dense transpose, and the product never launches
    ops.reset_launch_counts()
    dense = top.to_dense()
    v = torch.randn(top.n, 3, dtype=torch.float64)
    _close(top.rmm(v), (dense.T @ v).numpy())
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("kind", ["kron", "toeplitz"])
def test_validation_and_device(kind):
    """The JAX package's validation, and the device of the factors or an
    explicit ``device=``; ``to`` leaves the operator alone."""
    if kind == "kron":
        with pytest.raises(ValueError, match="square left factor"):
            tops.KroneckerOperator(torch.zeros(2, 3), torch.eye(2))
        op = tops.KroneckerOperator(np.eye(2, dtype=np.float32),
                                    torch.eye(3, dtype=torch.float64))
        assert op.dtype == torch.float64 and op.shape == (6, 6)
        with pytest.raises(ValueError, match=r"\(6, k\) slab"):
            op.mm(torch.zeros(5, 2))
    else:
        with pytest.raises(ValueError, match="first column"):
            tops.ToeplitzOperator(torch.zeros(2, 2))
        with pytest.raises(ValueError, match="complex"):
            tops.ToeplitzOperator(torch.ones(3, dtype=torch.complex128))
        with pytest.raises(ValueError, match="first row shape"):
            tops.ToeplitzOperator(torch.ones(3), torch.ones(4))
        op = tops.ToeplitzOperator(torch.tensor([2.0, 0.5, 0.1]))
        assert op.r is op.c and op.dtype == torch.float32
    assert op.device == torch.device("cpu")
    moved = op.to("cpu")
    assert moved is not op and torch.equal(moved.to_dense(), op.to_dense())
    assert est.operator_on(op, "cpu") is op


def _probes(n, k=8, seed=7):
    return np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, k))


def _bounds(dense):
    ev = np.linalg.eigvalsh(dense)
    return 0.9 * ev[0], 1.1 * ev[-1]


@pytest.mark.parametrize("name", SPD_CASES)
@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_estimators_match_jax(name, method):
    """The plan on each package's operator, same probes (and bounds):
    estimate and sem within 1e-12; the estimate also within 5 sem of the
    exact log|det|."""
    jop, top, _ = _cases()[name]
    dense = np.asarray(jop.to_dense())
    z = _probes(jop.shape[0])
    kw = dict(degree=48) if method == "chebyshev" else dict(num_steps=20)
    call = {"probes": z}
    if method == "chebyshev":
        call["lmin"], call["lmax"] = _bounds(dense)
    want = repro.plan(jop, method=method, num_probes=8, **kw)(
        **{k: (jnp.asarray(v) if k == "probes" else v)
           for k, v in call.items()})
    got = repro_torch.plan(top, method=method, num_probes=8, device="cpu",
                           **kw)(**{k: (torch.from_numpy(v)
                                        if k == "probes" else v)
                                    for k, v in call.items()})
    _close(got.logabsdet, want.logabsdet)
    _close(got.sem, want.sem)
    exact = np.linalg.slogdet(dense)[1]
    assert abs(float(got.logabsdet) - exact) <= 5 * float(got.sem) + 1e-6


@pytest.mark.parametrize("name", SPD_CASES)
@pytest.mark.parametrize("transpose", [False, True])
def test_cg_matches_jax(name, transpose):
    jop, top, _ = _cases()[name]
    b = np.random.default_rng(9).standard_normal((jop.shape[0], 3))
    want = jax_cg_solve(jop, jnp.asarray(b), tol=1e-13, transpose=transpose)
    got = est.cg_solve(top, torch.from_numpy(b), tol=1e-13,
                       transpose=transpose, device="cpu")
    _close(got.x, want.x)
    assert bool(got.converged) and got.iters == int(want.iters)


def _grad_kron(method, z, kw, fa, fb):
    def jfn(p):
        return jax_estimate_logdet(jops.KroneckerOperator(p[0], p[1]),
                                   method=method, probes=jnp.asarray(z),
                                   **kw).est
    want = jax.grad(jfn)((jnp.asarray(fa), jnp.asarray(fb)))
    a = torch.from_numpy(fa).requires_grad_()
    b = torch.from_numpy(fb).requires_grad_()
    est.estimate_logdet(tops.KroneckerOperator(a, b), method=method,
                        probes=torch.from_numpy(z), device="cpu",
                        **kw).est.backward()
    return (a.grad, b.grad), want


def _grad_toeplitz(method, z, kw, c):
    want = jax.grad(lambda cc: jax_estimate_logdet(
        jops.ToeplitzOperator(cc), method=method, probes=jnp.asarray(z),
        **kw).est)(jnp.asarray(c))
    ct = torch.from_numpy(c).requires_grad_()
    est.estimate_logdet(tops.ToeplitzOperator(ct), method=method,
                        probes=torch.from_numpy(z), device="cpu",
                        **kw).est.backward()
    return (ct.grad,), (want,)


@pytest.mark.parametrize("kind", ["kron", "toeplitz"])
@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_gradients_match_jax(kind, method):
    """Autograd of the port's estimate (the Hutchinson pullback onto the
    factors, or onto the one first column of a symmetric Toeplitz, both
    halves of its cotangent) against ``jax.grad`` on the same probes."""
    if kind == "kron":
        fa, fb = _spd(7, 1), _spd(5, 2)
        dense = np.kron(fa, fb)
    else:
        fa = _toeplitz_cols()[0]
        dense = np.asarray(jops.ToeplitzOperator(jnp.asarray(fa)).to_dense())
    z = _probes(dense.shape[0])
    kw = dict(num_probes=8)
    if method == "chebyshev":
        lo, hi = _bounds(dense)
        kw.update(degree=48, lmin=lo, lmax=hi)
    else:
        kw.update(num_steps=20)
    got, want = (_grad_kron(method, z, kw, fa, fb) if kind == "kron"
                 else _grad_toeplitz(method, z, kw, fa))
    for g, w in zip(got, want):
        _close(g, w)


def test_nonsymmetric_toeplitz_pullback_matches_jax():
    """The bilinear pullback ``sum w * T(c, r) z`` onto (c, r) of a
    non-symmetric Toeplitz, through the port's registration (``apply``
    defaults to the rebuilt operator's own ``mm``) and `jax.vjp`."""
    c, r = _toeplitz_cols()
    rng = np.random.default_rng(4)
    z, w = rng.standard_normal((37, 5)), rng.standard_normal((37, 5))
    info = est.operator_grad_info(tops.ToeplitzOperator(torch.from_numpy(c),
                                                        torch.from_numpy(r)))
    assert info is not None and not info.dense
    ct = torch.from_numpy(c).requires_grad_()
    rt = torch.from_numpy(r).requires_grad_()
    op = info.rebuild(None, (ct, rt))
    (torch.from_numpy(w) * op.mm(torch.from_numpy(z))).sum().backward()
    _, pull = jax.vjp(lambda p: (jnp.asarray(w) * jops.ToeplitzOperator(
        p[0], p[1]).mm(jnp.asarray(z))).sum(), (jnp.asarray(c),
                                               jnp.asarray(r)))
    (gc, gr), = pull(jnp.ones(()))
    _close(ct.grad, gc)
    _close(rt.grad, gr)


@pytest.mark.parametrize("kind", ["kron", "toeplitz"])
def test_value_and_grad_shapes(kind):
    """``plan(op).value_and_grad`` gives the parameters' shapes (never an
    (n, n) tangent), the value equal to ``__call__``'s, and a symmetric
    Toeplitz both halves of its cotangent, whose sum is the autograd
    gradient of its one column."""
    if kind == "kron":
        op = tops.KroneckerOperator(torch.from_numpy(_spd(7, 1)),
                                    torch.from_numpy(_spd(5, 2)))
        shapes = [(7, 7), (5, 5)]
    else:
        op = tops.ToeplitzOperator(torch.from_numpy(_toeplitz_cols()[0]))
        shapes = [(37,), (37,)]
    p = repro_torch.plan(op, method="slq", num_steps=20, num_probes=8,
                         device="cpu")
    res, bar = p.value_and_grad(generator=torch.Generator().manual_seed(1))
    call = p(generator=torch.Generator().manual_seed(1))
    assert torch.equal(res.logabsdet, call.logabsdet)
    assert [tuple(b.shape) for b in bar] == shapes
    assert res.diagnostics.cg_iters > 0
    if kind == "toeplitz":
        c = op.c.clone().requires_grad_()
        p.logdet(tops.ToeplitzOperator(c),
                 generator=torch.Generator().manual_seed(1)).backward()
        _close(c.grad, (bar[0] + bar[1]).numpy(), rtol=1e-10)


@pytest.mark.parametrize("kind", ["kron", "toeplitz"])
def test_auto_takes_an_estimator(kind):
    """Neither operator is materializable, so auto stays with the
    estimators, as in the JAX package."""
    jop, top, _ = _cases()["kron_spd" if kind == "kron" else "toeplitz_sym"]
    assert repro_torch.plan(top, device="cpu").method \
        == repro.plan(jop).method == "slq"
    assert repro_torch.select_method(top) == "slq"


# --------------------------------------------------------------------------
# the gmm_loglik.py twin
# --------------------------------------------------------------------------

def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_exact_matches_the_jax_example(monkeypatch):
    """Exact logdets and direct solves: the twin's log-likelihood per
    iteration equals the JAX example's printed figures (same data, same
    EM), and the recovered weights are uniform."""
    twin = _load("gmm_loglik_torch")
    hist = twin.run(dim=24, iters=3, device="cpu", log=False)
    monkeypatch.setattr(sys, "argv", ["gmm_loglik.py", "--dim", "24",
                                      "--iters", "3"])
    out = io.StringIO()
    with redirect_stdout(out):
        _load("gmm_loglik").main()
    lines = [l for l in out.getvalue().splitlines() if l.startswith("iter")]
    want = [float(l.split("=")[1].split()[0]) for l in lines]
    assert len(want) == 3 and hist["logdet"] == "exact"
    np.testing.assert_allclose(hist["ll"], want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(hist["weights"], [1 / 3] * 3, atol=2e-3)


def test_twin_cg_agrees_with_exact_within_sem():
    """``--logdet slq --solver cg`` (one plan on the operator, CG solves)
    against ``--logdet exact --solver direct``: finite, every logdet within
    5 sem of the exact one, the log-likelihoods within 5 sem of theirs
    (a mean over the components of -ld/2)."""
    twin = _load("gmm_loglik_torch")
    a = twin.run(dim=48, iters=3, logdet="slq", solver="cg", device="cpu",
                 log=False)
    b = twin.run(dim=48, iters=3, device="cpu", log=False)
    assert a["logdet"] == "slq" and a["cg_iters"][-1] > 0
    for ll_a, ll_b, ld_a, ld_b, sem in zip(a["ll"], b["ll"], a["ld"],
                                           b["ld"], a["sem"]):
        assert np.isfinite(ll_a)
        for x, y, s in zip(ld_a, ld_b, sem):
            assert abs(x - y) <= 5 * s + 1e-4 * max(abs(y), 1.0)
        sem_ll = 0.5 * np.sqrt(np.sum(np.square(sem))) / len(sem)
        assert abs(ll_a - ll_b) <= 5 * sem_ll + 1e-4 * max(abs(ll_b), 1.0)


def test_twin_main_parses_the_jax_flags(capsys):
    twin = _load("gmm_loglik_torch")
    hist = twin.main(["--dim", "16", "--iters", "2", "--logdet", "auto",
                      "--solver", "cg", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "auto-selected logdet method: slq" in out
    assert hist["logdet"] == "slq" and len(hist["ll"]) == 2
