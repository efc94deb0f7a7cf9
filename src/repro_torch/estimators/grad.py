"""The estimator dispatch by name, forward half.

Counterpart of the forward half of `repro.estimators.grad`:
`estimate_logdet` draws the probe slab once (`shared_probes`, the slab
the named estimator would draw itself) and runs the estimator on it.
The JAX package wraps this in a custom VJP whose backward pass reuses the
same probes in one CG solve; that, the structured pullbacks and
`hutchinson_pullback` are not ported yet (ROADMAP Queue 1 items 5 and
7), and an input that requires a gradient raises.
"""
from __future__ import annotations

import torch

from repro_torch.estimators.chebyshev import (
    default_generator, logdet_chebyshev,
)
from repro_torch.estimators.hutchinson import TraceEstimate, make_probes
from repro_torch.estimators.operators import operator_on
from repro_torch.estimators.operators.base import device_of
from repro_torch.estimators.slq import logdet_slq

__all__ = ["ESTIMATOR_METHODS", "estimate_logdet", "shared_probes"]

_ESTIMATORS = {"chebyshev": logdet_chebyshev, "slq": logdet_slq}
ESTIMATOR_METHODS = tuple(_ESTIMATORS)


def shared_probes(method: str, op, generator: torch.Generator,
                  kw: dict) -> torch.Tensor:
    """The probe slab the named estimator would draw from ``generator``:
    ``kw["num_probes"]`` columns (default 32), Rademacher, or
    ``kw["probe_kind"]`` for Chebyshev."""
    num = kw.get("num_probes", 32)
    kind = (kw.get("probe_kind", "rademacher") if method == "chebyshev"
            else "rademacher")
    return make_probes(generator, op.shape[-1], num, kind=kind,
                       dtype=op.dtype, device=device_of(op))


def _requires_grad(op) -> bool:
    return any(getattr(getattr(op, name, None), "requires_grad", False)
               for name in ("a", "bands"))


def estimate_logdet(a, method: str = "chebyshev", *, device=None,
                    **kw) -> TraceEstimate:
    """Run the estimator ``method`` ("chebyshev" | "slq") on ``a``, on
    ``device`` (`operator_on`: ``None`` is the card, ``"cpu"`` the plain
    versions).

    See `logdet_chebyshev` / `logdet_slq` for the keywords; ``generator``
    (else ``seed``) draws the probes unless ``probes`` supplies them.
    """
    if method not in _ESTIMATORS:
        raise ValueError(
            f"unknown estimator {method!r}; choose from {ESTIMATOR_METHODS}")
    op = operator_on(a, device, mesh=kw.pop("mesh", None))
    if _requires_grad(op):
        raise NotImplementedError(
            "repro_torch does not run estimator gradients yet (ROADMAP "
            "Queue 1 items 5 and 7)")
    generator = kw.pop("generator", None)
    seed = kw.pop("seed", 0)
    if generator is None:
        generator = default_generator(device_of(op), seed)
    probes = kw.pop("probes", None)
    if probes is None:
        probes = shared_probes(method, op, generator, kw)
    return _ESTIMATORS[method](op, generator=generator, probes=probes,
                               device=device_of(op), **kw)
