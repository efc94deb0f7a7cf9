"""The exact gradient of a singular matrix, port against the JAX package.

``d log|det A| / dA = A^{-T}`` has no finite value where A is singular.
The JAX package's backward is ``jnp.linalg.inv``, which returns inf/NaN
entries there; the port's is ``torch.linalg.inv_ex(a).inverse``, which
does the same and raises nothing.  So a (B, n, n) stack with one
degenerate matrix gives every other matrix its exact gradient, in both
packages.

A singular matrix's entries are not compared: they depend on rounding
(in both packages the forward of an exactly singular matrix does too).
Only their non-finiteness is held, and the regular matrices' values.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro
import repro_torch
from repro_torch.analysis import record
from repro_torch.analysis.passes import _factorization
from repro_torch.core.plan import clear_plan_cache

RANK2 = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]])
CASES = {
    "rank2": RANK2,
    "zero": np.zeros((3, 3)),
    "stack": np.stack([np.eye(3), RANK2]),     # matrix 0 regular
}
# which matrices of each case are singular (a 2-D case is one matrix)
SINGULAR = {"rank2": [True], "zero": [True], "stack": [False, True]}
ROUTES = {
    "rank1": dict(method="exact", update="rank1"),
    "panel": dict(method="exact", update="panel", k=2),
    "ge": dict(method="ge"),
}
RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(autouse=True)
def _fresh_plans():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _finite_per_matrix(g) -> list:
    g = np.asarray(g)
    return list(np.isfinite(g).all(axis=(-2, -1)).reshape(-1))


def _jax_grads(a, kw):
    """(value_and_grad's gradient, jax.grad of the summed logdet)."""
    p = repro.plan(jnp.asarray(a), **kw)
    _, g_vag = p.value_and_grad()
    g = jax.grad(lambda y: p.logdet(y).sum())(jnp.asarray(a))
    return np.asarray(g_vag), np.asarray(g)


def _check(got, want, case, dtype):
    """Same shape; the regular matrices equal within ``RTOL``; every
    singular one non-finite in both."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape == CASES[case].shape
    fin_got, fin_want = _finite_per_matrix(got), _finite_per_matrix(want)
    assert fin_want == [not s for s in SINGULAR[case]]
    assert fin_got == fin_want
    g3, w3 = got.reshape(-1, 3, 3), want.reshape(-1, 3, 3)
    for b, singular in enumerate(SINGULAR[case]):
        if not singular:
            np.testing.assert_allclose(g3[b], w3[b], rtol=RTOL[dtype],
                                       atol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_value_and_grad_on_singular_input(route, case, dtype):
    """``plan.value_and_grad`` raises nothing; its gradient matches the
    JAX plan's on the regular matrices and is non-finite on the singular
    ones, as JAX's is."""
    a = CASES[case].astype(dtype)
    kw = ROUTES[route]
    res, g = repro_torch.plan(torch.from_numpy(a), device="cpu",
                              **kw).value_and_grad()
    assert g.dtype == getattr(torch, dtype)
    assert res.logabsdet.shape == a.shape[:-2]
    want, _ = _jax_grads(a, kw)
    _check(g, want, case, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_backward_on_singular_input(route, case, dtype):
    """Autograd through ``plan.logdet`` raises nothing in ``backward``;
    the gradient holds against ``jax.grad`` of the JAX plan as above."""
    a = CASES[case].astype(dtype)
    kw = ROUTES[route]
    x = torch.from_numpy(a).requires_grad_()
    ld = repro_torch.plan(x.detach(), device="cpu", **kw).logdet(x)
    ld.sum().backward()
    assert x.grad.dtype == getattr(torch, dtype)
    _, want = _jax_grads(a, kw)
    _check(x.grad, want, case, dtype)


def test_regular_stack_gradient_is_the_inverse():
    """The stack's regular matrix (I) gets I back, exactly as numpy's."""
    x = torch.from_numpy(CASES["stack"]).requires_grad_()
    repro_torch.plan(x.detach(), method="exact", device="cpu") \
        .logdet(x).sum().backward()
    assert torch.equal(x.grad[0], torch.eye(3, dtype=torch.float64))


def test_recorded_exact_backward_is_one_inverse_and_audits_clean():
    """The recording of an exact ``value_and_grad`` holds ``linalg_inv_ex``,
    which the audit's factorization matcher counts (so a matrix-free
    context would still flag it), makes no host read, and the exact
    plan's audit with ``include_grad`` stays clean."""
    a = torch.from_numpy(np.eye(8) * 2.0 + 0.1)
    p = repro_torch.plan(a, method="exact", device="cpu")
    mod = record(lambda: p.value_and_grad(a))
    inv = [i for i in mod.instructions if "linalg_inv_ex" in i.opcode]
    assert len(inv) == 1 and _factorization(inv[0], 8)
    assert not [i for i in mod.instructions if i.opcode.startswith("host.")]
    report = p.audit(include_grad=True)
    assert report.ok, report.summary()
