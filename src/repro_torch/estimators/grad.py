"""Differentiable log-determinants: autograd rules for every path.

Counterpart of `repro.estimators.grad`.  The derivative is

    d logdet(A) = tr(A^{-1} dA),      i.e.  d logdet / dA = A^{-T},

and neither the condensation pivot schedule nor the estimator recurrences
are differentiated through: pivoting is piecewise control flow, the
recurrences would retain every slab, and on the card the kernels write
their outputs through ctypes, which autograd cannot see.  So each path
is one `torch.autograd.Function` whose forward runs the existing code on
the detached input with gradients off:

Exact methods (``exact``, ``ge``, ``pge``, ``plu``)
    `exact_slogdet_vjp` wraps ``a -> (sign, logabsdet)``; its backward is
    ``g * inv(a).T`` (one `torch.linalg.inv_ex`, cuSOLVER on the card, as
    the JAX package leaves ``jnp.linalg.inv`` to XLA).  A singular matrix
    gets inf/NaN entries, as from ``jnp.linalg.inv``, and no error: one
    degenerate matrix of a stack leaves the others their exact gradients,
    and the card makes no host check of the factorization's ``info``.
    The sign is non-differentiable.

Estimator methods (``chebyshev``, ``slq``)
    `estimate_logdet` draws the probe slab once (`shared_probes`) and, when
    the operator's parameters require a gradient, runs the estimator
    inside a Function whose backward is `hutchinson_pullback`: one
    transposed CG solve ``A^T W = Z`` on the forward's own probes, then the
    dense closed form ``(g/k) W Z^T`` or the bilinear pullback of
    ``sum_c w_c^T A(theta) z_c`` onto the operator's parameters (the
    stencil's bands).  ``sem`` and ``samples`` are non-differentiable.

Operators opt in through `register_operator_grad`, with the JAX package's
four fields; ``params`` is a tensor or a flat tuple/list of tensors.  An
unregistered operator runs the plain forward (autograd then sees whatever
its ``mm`` records).  A `BatchedOperator` stack is registered as dense
(its parameters are the (B, n, n) entries): one batched transposed CG,
then ``(g_b/k) W_b Z_b^T`` per matrix with ``g`` (B,); the exact backward
of a stack is one batched inverse.  `KroneckerOperator` (parameters ``(a,
b)``) and `ToeplitzOperator` (``(c, r)``) take the bilinear pullback
through their own ``mm`` (reshaped products, FFTs: autograd sees them,
since no ctypes kernel runs there), so their cotangents are
factor-shaped and column/row-shaped, never (n, n).  The rules are
once-differentiable.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.estimators.chebyshev import (
    default_generator, logdet_chebyshev,
)
from repro_torch.estimators.hutchinson import TraceEstimate, make_probes
from repro_torch.estimators.operators import (
    BatchedOperator, DenseOperator, KroneckerOperator, ShardedOperator,
    StencilOperator, ToeplitzOperator, cg_solve, operator_on,
)
from repro_torch.estimators.operators.base import device_of
from repro_torch.estimators.operators.stencil import _transpose_bands
from repro_torch.estimators.slq import logdet_slq
from repro_torch.kernels import ops as _kops

__all__ = [
    "ESTIMATOR_METHODS", "estimate_logdet", "exact_slogdet_vjp",
    "hutchinson_pullback", "shared_probes", "stencil_apply",
    "register_operator_grad", "operator_grad_info", "OperatorGradInfo",
]

_ESTIMATORS = {"chebyshev": logdet_chebyshev, "slq": logdet_slq}
ESTIMATOR_METHODS = tuple(_ESTIMATORS)


# --------------------------------------------------------------------------
# operator registry: how each backend exposes its differentiable parameters
# --------------------------------------------------------------------------

class OperatorGradInfo(NamedTuple):
    """How the gradient rules see one operator class.

    ``params(op)`` returns the differentiable parameters (a tensor, or a
    flat tuple/list of tensors); ``rebuild(op, params)`` makes an
    equivalent operator from them, reading only static attributes
    (offsets, mesh) off ``op``; ``apply(op, params, z)`` computes
    ``A(params) @ z`` differentiably for the bilinear pullback (default
    ``rebuild(op, params).mm(z)``); ``dense=True`` takes the closed form
    ``(g/k) W Z^T`` instead, when the parameters are the matrix entries.
    """
    params: Callable[[Any], Any]
    rebuild: Callable[[Any, Any], Any]
    apply: Optional[Callable[[Any, Any, torch.Tensor], torch.Tensor]] = None
    dense: bool = False


_REGISTRY: dict = {}


def register_operator_grad(cls, *, params, rebuild, apply=None,
                           dense: bool = False) -> None:
    """Register the gradient rule of an operator class (see
    `OperatorGradInfo`)."""
    _REGISTRY[cls] = OperatorGradInfo(params, rebuild, apply, dense)


def operator_grad_info(op) -> Optional[OperatorGradInfo]:
    """The registration of ``op``'s class, else of its nearest registered
    base, else None."""
    info = _REGISTRY.get(type(op))
    if info is not None:
        return info
    for cls, entry in _REGISTRY.items():
        if isinstance(op, cls):
            return entry
    return None


class _StencilApply(torch.autograd.Function):
    """``A(bands) @ z`` through `kernels.ops.stencil_mv` (K8 on the card),
    with the bands' cotangent in closed form:
    ``bar[d, i] = sum_c w[i, c] z[i + off_d, c]``, zero outside [0, n)."""

    @staticmethod
    def forward(ctx, bands, z, offsets):
        ctx.offsets = offsets
        ctx.save_for_backward(bands, z)
        return _kops.stencil_mv(bands.contiguous(), z.contiguous(),
                                offsets=offsets)

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        bands, z = ctx.saved_tensors
        offsets = ctx.offsets
        bar_bands = bar_z = None
        if ctx.needs_input_grad[0]:
            n = z.shape[0]
            lo, hi = min(min(offsets), 0), max(max(offsets), 0)
            zp = torch.nn.functional.pad(z, (0, 0, -lo, hi))
            bar_bands = torch.stack([
                (w * zp[off - lo:off - lo + n]).sum(-1) for off in offsets])
        if ctx.needs_input_grad[1]:
            # A^T w through the transposed band table
            bar_z = _kops.stencil_mv(_transpose_bands(bands, offsets),
                                     w.contiguous(),
                                     offsets=tuple(-o for o in offsets))
        return bar_bands, bar_z, None


def stencil_apply(op: StencilOperator, bands: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """``A(bands) @ z`` for ``op``'s offsets, differentiable in ``bands``
    and ``z`` (the stencil's ``apply``)."""
    return _StencilApply.apply(bands, z.to(bands.dtype), op.offsets)


register_operator_grad(
    DenseOperator,
    params=lambda op: op.a,
    rebuild=lambda op, a: DenseOperator(a),
    dense=True)
register_operator_grad(
    BatchedOperator,
    params=lambda op: op.stack,
    rebuild=lambda op, s: BatchedOperator(s),
    dense=True)
register_operator_grad(
    ShardedOperator,
    params=lambda op: op.a,
    rebuild=lambda op, a: ShardedOperator(a, op.mesh),
    dense=True)
register_operator_grad(
    KroneckerOperator,
    params=lambda op: (op.a, op.b),
    rebuild=lambda op, p: KroneckerOperator(p[0], p[1]))
register_operator_grad(
    ToeplitzOperator,
    # a symmetric operator holds the same tensor as c and r: it enters the
    # autograd Function twice, so both halves of the cotangent flow back
    # into the one first-column parameter
    params=lambda op: (op.c, op.r),
    rebuild=lambda op, p: ToeplitzOperator(p[0], p[1]))
register_operator_grad(
    StencilOperator,
    params=lambda op: op.bands,
    rebuild=lambda op, b: StencilOperator(op.offsets, b),
    apply=stencil_apply)


def _leaves(params) -> tuple:
    return tuple(params) if isinstance(params, (tuple, list)) else (params,)


def _unflatten(params, leaves):
    if isinstance(params, (tuple, list)):
        return type(params)(leaves)
    return leaves[0]


# --------------------------------------------------------------------------
# exact methods: one VJP for every route
# --------------------------------------------------------------------------

class _ExactSlogdet(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, fn):
        if a.is_meta:       # shape only (the dry run, `layout.step_plan`)
            sign, ld = (torch.empty(a.shape[:-2], dtype=a.dtype,
                                    device=a.device) for _ in range(2))
        else:
            with torch.no_grad():
                sign, ld = fn(a.detach())
        ctx.save_for_backward(a)
        ctx.mark_non_differentiable(sign)
        return sign, ld

    @staticmethod
    @once_differentiable
    def backward(ctx, g_sign, g_ld):
        (a,) = ctx.saved_tensors
        if a.shape[-1] == 0:
            return torch.zeros_like(a), None
        # g_ld is 0-d, or (B,) for a stack: each matrix's cotangent
        inv = torch.linalg.inv_ex(a).inverse
        return (g_ld[..., None, None] * inv.mT).to(a.dtype), None


def exact_slogdet_vjp(fn: Callable[[torch.Tensor], Any]):
    """Wrap an exact ``a -> (sign, logabsdet)`` computation with its VJP.

    ``fn`` runs on the detached input with gradients off, so no graph is
    built through the elimination; the backward is ``g * inv(a).T`` in
    ``a``'s dtype (zeros at n = 0), and the sign's cotangent is dropped.
    A (B, n, n) stack takes one batched inverse.
    """
    def f(a):
        return _ExactSlogdet.apply(a, fn)
    return f


# --------------------------------------------------------------------------
# estimator methods: Hutchinson pullback on the forward's own probes
# --------------------------------------------------------------------------

def shared_probes(method: str, op, generator: torch.Generator,
                  kw: dict) -> torch.Tensor:
    """The probe slab the named estimator would draw from ``generator``:
    ``kw["num_probes"]`` columns (default 32), Rademacher, or
    ``kw["probe_kind"]`` for Chebyshev; (B, n, k) for a stack."""
    num = kw.get("num_probes", 32)
    kind = (kw.get("probe_kind", "rademacher") if method == "chebyshev"
            else "rademacher")
    batch = getattr(op, "batch", None)
    return make_probes(generator, op.shape[-1], num, kind=kind,
                       dtype=op.dtype, device=device_of(op),
                       batch_shape=(batch,) if batch else ())


def hutchinson_pullback(op, params, probes, g, *, info=None,
                        cg_tol: float = 1e-8, cg_maxiter=None):
    """The log-determinant's cotangent on an operator's parameters,
    matrix-free -> ``(bar_params, CGResult)``.

    Solves ``A^T W = Z`` (``Z`` = ``probes``, one transposed CG through
    ``rmm``) on ``rebuild(op, params)``, then returns ``(g/k) W Z^T`` for
    a dense registration, else the gradient of ``sum((g/k) W * apply(op,
    params, Z))`` with respect to ``params`` (shaped like them).  On a
    stack ``g`` is (B,) and every matrix takes its own ``g_b``.
    """
    info = operator_grad_info(op) if info is None else info
    if info is None:
        raise TypeError(
            f"no gradient registration for {type(op).__name__}; register "
            "one with repro_torch.estimators.register_operator_grad")
    leaves = [t.detach() for t in _leaves(params)]
    op_b = info.rebuild(op, _unflatten(params, leaves))
    cg = cg_solve(op_b, probes, transpose=True, tol=cg_tol,
                  maxiter=cg_maxiter, device=device_of(op_b))
    w = cg.x                                           # A^{-T} Z
    k = probes.shape[-1]
    scale = torch.as_tensor(g, dtype=probes.dtype,
                            device=probes.device) / k
    w2 = scale[..., None, None] * w     # (..., n, k): cheaper than bar
    if info.dense:
        return w2 @ probes.mT, cg
    apply_fn = info.apply or (lambda o, pp, zz: info.rebuild(o, pp).mm(zz))
    with torch.enable_grad():
        live = [t.requires_grad_() for t in leaves]
        out = apply_fn(op, _unflatten(params, live), probes)
        bars = torch.autograd.grad((w2 * out).sum(), live,
                                   allow_unused=True)
    bars = [torch.zeros_like(t) if b is None else b
            for b, t in zip(bars, live)]
    return _unflatten(params, bars), cg


class _EstimateVJP(torch.autograd.Function):
    """One estimator call as a function of the operator's parameters."""

    @staticmethod
    def forward(ctx, run, pullback, *leaves):
        with torch.no_grad():
            res = run([t.detach() for t in leaves])
        ctx.pullback = pullback
        ctx.save_for_backward(*leaves)
        ctx.mark_non_differentiable(res.sem, res.samples)
        return res.est, res.sem, res.samples

    @staticmethod
    @once_differentiable
    def backward(ctx, g_est, g_sem, g_samples):
        leaves = ctx.saved_tensors
        bars = ctx.pullback(leaves, g_est)
        return (None, None, *(b.to(device=t.device, dtype=t.dtype)
                              for b, t in zip(bars, leaves)))


def _requires_grad(params) -> bool:
    return any(torch.is_tensor(t) and t.requires_grad
               for t in _leaves(params))


def estimate_logdet(a, method: str = "chebyshev", *, device=None,
                    **kw) -> TraceEstimate:
    """Run the estimator ``method`` ("chebyshev" | "slq") on ``a``, on
    ``device`` (`operator_on`: ``None`` is the card, ``"cpu"`` the plain
    versions) -- differentiably.

    See `logdet_chebyshev` / `logdet_slq` for the keywords; ``generator``
    (else ``seed``) draws the probes unless ``probes`` supplies them.
    When the operator is registered (`operator_grad_info`) and its
    parameters require a gradient, ``est`` backpropagates through
    `hutchinson_pullback` on the same probes (``grad_cg_tol`` /
    ``grad_cg_maxiter`` control its solve); the forward value is the same
    either way.
    """
    if method not in _ESTIMATORS:
        raise ValueError(
            f"unknown estimator {method!r}; choose from {ESTIMATOR_METHODS}")
    op = operator_on(a, device, mesh=kw.pop("mesh", None))
    cg_tol = kw.pop("grad_cg_tol", 1e-8)
    cg_maxiter = kw.pop("grad_cg_maxiter", None)
    dev = device_of(op)
    generator = kw.pop("generator", None)
    seed = kw.pop("seed", 0)
    if generator is None:
        generator = default_generator(dev, seed)
    probes = kw.pop("probes", None)
    if probes is None:
        probes = shared_probes(method, op, generator, kw)
    fwd = _ESTIMATORS[method]
    info = operator_grad_info(op)
    params = None if info is None else info.params(op)
    if not (torch.is_grad_enabled() and info is not None
            and _requires_grad(params)):
        return fwd(op, generator=generator, probes=probes, device=dev, **kw)
    probes = torch.as_tensor(probes).to(device=dev, dtype=op.dtype)

    def run(leaves):
        op_d = info.rebuild(op, _unflatten(params, leaves))
        return fwd(op_d, generator=generator, probes=probes, device=dev,
                   **kw)

    def pullback(leaves, g):
        bar, _ = hutchinson_pullback(op, _unflatten(params, leaves), probes,
                                     g, info=info, cg_tol=cg_tol,
                                     cg_maxiter=cg_maxiter)
        return _leaves(bar)

    return TraceEstimate(*_EstimateVJP.apply(run, pullback,
                                             *_leaves(params)))
