"""Hutchinson trace estimation: probe generation and variance tracking.

Counterpart of `repro.estimators.hutchinson`:

    tr(f(A)) = E[ v^T f(A) v ],   E[v v^T] = I

with Rademacher (entries +-1, the variance-minimizing classical choice)
or Gaussian probes.  Probe slabs are (n, k), k probes as columns;
quadratic-form samples (k,); estimates 0-d -- or, for a
`BatchedOperator` stack, with a leading batch axis: (B, n, k), (B, k),
(B,).

Randomness comes from an explicit `torch.Generator`; there is no global
random state.  The JAX package's keys and PyTorch's generators give other
numbers from the same seed, so a comparison of the two hands both the
same ``probes``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.estimators.operators.base import resolve_device
from repro_torch.obs import telemetry as _telemetry

__all__ = ["make_probes", "mean_sem", "hutchinson_trace", "TraceEstimate",
           "PROBE_KINDS"]

PROBE_KINDS = ("rademacher", "gaussian")


class TraceEstimate(NamedTuple):
    """Estimate with uncertainty: ``est`` +- ``sem`` from ``samples``."""
    est: torch.Tensor       # (...,) mean over probes
    sem: torch.Tensor       # (...,) standard error of the mean
    samples: torch.Tensor   # (..., k) per-probe quadratic forms


def make_probes(generator: torch.Generator, n: int, num: int, *,
                kind: str = "rademacher",
                dtype: Optional[torch.dtype] = None,
                device=None, batch_shape: Tuple[int, ...] = ()
                ) -> torch.Tensor:
    """(*batch_shape, n, num) slab of i.i.d. probe columns, E[v v^T] = I.

    Drawn on the generator's device and moved to ``device`` (default: the
    generator's).  ``dtype`` should be threaded from the operator
    (``op.dtype``) so the slab matches it; default is PyTorch's default
    float dtype.
    """
    if kind not in PROBE_KINDS:
        raise ValueError(f"unknown probe kind {kind!r}; choose {PROBE_KINDS}")
    dtype = torch.get_default_dtype() if dtype is None else dtype
    if not dtype.is_floating_point:
        raise ValueError(f"probes must be real floating, got {dtype}")
    gdev = generator.device
    shape = (*batch_shape, n, num)
    if kind == "rademacher":
        bits = torch.randint(0, 2, shape, generator=generator, device=gdev)
        v = (2 * bits - 1).to(dtype)
    else:
        v = torch.randn(shape, generator=generator, device=gdev,
                        dtype=dtype)
    return v if device is None else v.to(device)


def mean_sem(samples: torch.Tensor):
    """Mean and standard error over the trailing probe axis."""
    k = samples.shape[-1]
    est = samples.mean(-1)
    if k < 2:
        return est, torch.full_like(est, math.inf)
    return est, samples.std(-1, correction=1) / math.sqrt(k)


def hutchinson_trace(mm, probes, *, device=None) -> TraceEstimate:
    """Trace of the operator behind ``mm`` from a probe slab.

    ``mm`` maps (..., n, k) -> (..., n, k) on ``device`` (`resolve_device`: ``None``
    is the card, ``"cpu"`` the CPU); ``probes`` is the slab from
    `make_probes`, moved there.  Returns the estimate with its standard
    error.
    """
    probes = torch.as_tensor(probes).to(resolve_device(device))
    samples = (probes * mm(probes)).sum(-2)          # v_i^T A v_i per column
    est, sem = mean_sem(samples)
    if _telemetry.enabled():
        # REPRO_OBS=trace: the sem-vs-probes curve to the host buffer
        _telemetry.emit_curve("hutchinson.sem", _telemetry.running_sem(samples))
    return TraceEstimate(est, sem, samples)
