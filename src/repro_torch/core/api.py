"""Legacy string-dispatch log-determinant API -- deprecated shims over
``repro_torch.plan``, and the determinant-preserving padding the plans use.

Counterpart of `repro.core.api`.  ``slogdet(a, method=..., mesh=...,
**kwargs)``, ``logdet`` and ``logdet_batched`` build (and cache) a
`repro_torch.core.plan.LogdetPlan` per (spec, method, config, device,
mesh) and execute it, with the JAX package's defaults (``method="mc"``,
``"chebyshev"`` for stacks), validation order and error messages, and
emit a `DeprecationWarning` (counted as ``compat.deprecated{fn=...}``
with obs metrics on).  New code builds a plan once and calls it::

    p = repro_torch.plan((n, n), method="auto")
    sign, logabsdet = p(a)

Like every entry point of the port they run on the card unless
``device="cpu"`` is given; the estimators take the port's call-time
``generator=`` where the JAX package takes ``key=``.

`pad_to_multiple` is not deprecated: it is the shared embedding
primitive (``A -> diag(A, I)``, determinant-preserving) that plans and
the parallel schedules use.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.configs import (
    ESTIMATOR_METHODS as _EST_METHODS, METHODS, PARALLEL_METHODS,
)

__all__ = ["slogdet", "logdet", "logdet_batched", "pad_to_multiple",
           "METHODS"]

_PARALLEL = set(PARALLEL_METHODS)
_ESTIMATOR = set(_EST_METHODS)


def pad_to_multiple(a: torch.Tensor, mult: int) -> torch.Tensor:
    """Embed ``a`` in ``diag(a, I_pad)`` so N becomes a multiple of ``mult``;
    each matrix of a (B, N, N) stack alike.

    The result keeps ``a``'s dtype and device; ``a`` is returned as is
    when no padding is needed.
    """
    n = a.shape[-1]
    pad = (-n) % mult
    if pad == 0:
        return a
    out = torch.zeros((*a.shape[:-2], n + pad, n + pad), dtype=a.dtype,
                      device=a.device)
    out[..., :n, :n] = a
    idx = torch.arange(n, n + pad, device=a.device)
    out[..., idx, idx] = 1
    return out


def _warn_deprecated(name: str, repl: str):
    from repro_torch import obs
    obs.inc("compat.deprecated", fn=name)
    warnings.warn(
        f"repro_torch.core.{name}() is deprecated: build a plan once with "
        f"repro_torch.plan({repl}) and call it", DeprecationWarning,
        stacklevel=3)


def _runtime_bounds(est_kw: dict) -> dict:
    """Pop tensor lmin/lmax out of the config keywords.

    Typed configs are hashable scalars (they key the plan cache), so
    bounds that arrive as tensors (computed on the device, or carrying a
    gradient) ride as execution inputs instead: no host read, as the JAX
    shim threads traced bounds through."""
    rt = {}
    for name in ("lmin", "lmax"):
        if isinstance(est_kw.get(name), torch.Tensor):
            rt[name] = est_kw.pop(name)
    return rt


def _plan_call(a, method, mesh, axis_name, k, nb, device, est_kw):
    """Route one legacy call through a cached plan, preserving the string
    API's validation order and error messages."""
    from repro_torch.core.plan import plan as _make_plan
    from repro_torch.estimators.operators import is_operator as _is_op

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    if mesh is not None and axis_name != mesh.axis_name:
        raise ValueError(f"axis_name {axis_name!r} is not the mesh's axis "
                         f"{mesh.axis_name!r}")
    if _is_op(a):
        # operator inputs: only the matrix-free estimator methods apply
        if method not in _ESTIMATOR:
            raise TypeError(
                f"method {method!r} needs a materialized matrix; operator "
                f"inputs require an estimator method {sorted(_ESTIMATOR)}")
        if mesh is not None:
            raise TypeError("operator inputs carry their own distribution; "
                            "mesh is only accepted for dense array inputs")
        generator = est_kw.pop("generator", None)
        probes = est_kw.pop("probes", None)
        rt = _runtime_bounds(est_kw)
        p = _make_plan(a, method=method, validate=False, device=device,
                       **est_kw)
        return p.slogdet(a, generator=generator, probes=probes, **rt)

    a_t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    shape = tuple(a_t.shape)
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError(f"expected square matrix, got {shape}")

    if method in _ESTIMATOR:
        generator = est_kw.pop("generator", None)
        probes = est_kw.pop("probes", None)
        rt = _runtime_bounds(est_kw)
        p = _make_plan(a_t, method=method, mesh=mesh, validate=False,
                       device=device, **est_kw)
        return p.slogdet(a_t, generator=generator, probes=probes, **rt)

    kw = {"k": k, "nb": nb} if method in _PARALLEL or method == "mc_blocked" \
        else {}
    kw.update(est_kw)          # exact + estimator kwargs -> typed TypeError
    p = _make_plan(a_t, method=method, mesh=mesh, validate=False,
                   device=device, **kw)
    return p.slogdet(a_t)


def slogdet(a, *, method: str = "mc", mesh=None, axis_name: str = "rows",
            k: int = 32, nb: int = 1, device=None, **est_kw):
    """Sign and log|det| of a square matrix, numpy.linalg.slogdet
    semantics, on ``device`` (None: the card; with a mesh, its device).

    .. deprecated:: use ``repro_torch.plan(...)`` -- this shim builds a
       cached plan per (shape, method, config, device, mesh) and executes
       it.

    Estimator methods ("chebyshev", "slq") assume SPD input, return sign
    1, and accept the keywords of `ChebyshevConfig` / `SLQConfig` plus the
    call-time ``generator``/``probes`` (and tensor ``lmin``/``lmax``).
    Exact methods reject estimator keywords.  ``axis_name`` must name the
    mesh's axis (`Mesh.axis_name`).
    """
    _warn_deprecated("slogdet", "shape, method=...")
    return _plan_call(a, method, mesh, axis_name, k, nb, device, est_kw)


def logdet(a, *, method: str = "mc", mesh=None, axis_name: str = "rows",
           k: int = 32, nb: int = 1, device=None, **est_kw):
    """log|det(a)| -- the paper's quantity (sign discarded).

    .. deprecated:: use ``repro_torch.plan(...).logdet(a)``.
    """
    _warn_deprecated("logdet", "shape, method=...")
    return _plan_call(a, method, mesh, axis_name, k, nb, device, est_kw)[1]


def logdet_batched(stack, *, method: str = "chebyshev", device=None, **kw):
    """``log|det|`` per matrix of an SPD (B, N, N) stack -> (B,).

    .. deprecated:: use ``repro_torch.plan(stack.shape, method=...)`` -- a
       batched plan returns a `LogdetResult` whose fields carry the
       leading batch axis.
    """
    _warn_deprecated("logdet_batched", "(B, n, n), method=...")
    from repro_torch.core.plan import plan as _make_plan
    from repro_torch.estimators.operators import is_operator as _is_op

    if _is_op(stack):
        if getattr(stack, "batch", None) is None:
            raise ValueError(
                "logdet_batched needs a batched operator (with a .batch "
                "axis); use estimate_logdet for a single operator")
        if method not in _ESTIMATOR:
            raise TypeError(
                f"method {method!r} needs a materialized (B, n, n) stack; "
                "operator inputs require an estimator method "
                f"{_EST_METHODS}")
        generator = kw.pop("generator", None)
        probes = kw.pop("probes", None)
        p = _make_plan(stack, method=method, validate=False, device=device,
                       **kw)
        return p.logdet(stack, generator=generator, probes=probes)

    stack = stack if isinstance(stack, torch.Tensor) \
        else torch.as_tensor(stack)
    if stack.dim() != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected (B, n, n) stack, got "
                         f"{tuple(stack.shape)}")
    if method not in _ESTIMATOR:
        # any exact engine route on the whole stack; mesh schedules raise
        # a clear TypeError inside plan (ONE matrix per mesh)
        p = _make_plan(stack, method=method, validate=False, device=device,
                       **kw)
        return p.logdet(stack)
    generator = kw.pop("generator", None)
    probes = kw.pop("probes", None)
    p = _make_plan(stack, method=method, validate=False, device=device, **kw)
    return p.logdet(stack, generator=generator, probes=probes)
