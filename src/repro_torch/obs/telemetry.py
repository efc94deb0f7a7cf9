"""Convergence telemetry: host-side streams of the estimators' progress.

Counterpart of `repro.obs.telemetry`.  The JAX package stages a
``jax.debug.callback`` into its jitted estimators; eager PyTorch has no
staged code, so here the emits copy their values to the host buffers at
the call, and only in ``trace`` mode: with obs ``off`` or ``metrics``
they return before touching the tensor, so they add no host read.

Two emit shapes:

:func:`emit_curve`
    One call per execution carrying a whole 1-D curve (the running sem
    over probes 1..k, computed on the device by :func:`running_sem`).

:func:`emit_point`
    One call per loop iteration carrying ``(step, value)`` (CG's worst
    column residual).  :func:`drain` sorts by step.

The copies are synchronous, so :func:`flush` only waits for the card,
for symmetry with the JAX package's effects barrier.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List

import torch

from repro_torch.obs import config as _cfg

_lock = threading.Lock()
_curves: Dict[str, List[float]] = {}
_points: Dict[str, List[tuple]] = {}


def enabled() -> bool:
    """True when the emits record (trace mode)."""
    return _cfg.trace_enabled()


def emit_curve(name: str, values) -> None:
    """Append a 1-D curve to the stream ``name`` (trace mode only)."""
    if not enabled():
        return
    vals = [float(v) for v in torch.as_tensor(values).detach().reshape(-1)
            .tolist()]
    with _lock:
        _curves.setdefault(name, []).extend(vals)


def emit_point(name: str, value, step) -> None:
    """Append ``(step, value)`` to the stream ``name`` (trace mode only);
    ``value`` is a number or a one-element tensor."""
    if not enabled():
        return
    with _lock:
        _points.setdefault(name, []).append((int(step), float(value)))


def running_sem(samples: torch.Tensor) -> torch.Tensor:
    """Running standard error over sample prefixes, on the samples' device.

    ``samples[..., j]`` is the j-th probe's estimate; returns a curve of
    shape (k,) whose entry j-1 is the sem of the first j probes (averaged
    over leading dims).  Entry 0 is inf: one probe has no spread.
    """
    x = torch.as_tensor(samples).detach()
    x = x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x[None]
    k = x.shape[-1]
    idx = torch.arange(1, k + 1, dtype=x.dtype, device=x.device)
    mean = torch.cumsum(x, dim=-1) / idx
    var = (torch.cumsum(x * x, dim=-1) - idx * mean * mean) \
        / torch.clamp(idx - 1.0, min=1.0)
    sem = torch.sqrt(torch.clamp(var, min=0.0) / idx)
    sem[..., 0] = math.inf
    return sem.mean(dim=0)


def flush() -> None:
    """Wait for the card (the copies themselves are synchronous)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def drain() -> Dict[str, List[float]]:
    """Pop and return all buffered streams as ``{name: [floats]}``.

    Point streams are sorted by step.  Non-finite values are kept (the
    exporters sanitize them).
    """
    with _lock:
        curves = {k: list(v) for k, v in _curves.items()}
        points = {k: sorted(v) for k, v in _points.items()}
        _curves.clear()
        _points.clear()
    out: Dict[str, List[float]] = dict(curves)
    for name, pts in points.items():
        out[name] = [v for _, v in pts]
    return out


def peek() -> Dict[str, int]:
    """Stream names -> buffered lengths, without draining."""
    with _lock:
        out = {k: len(v) for k, v in _curves.items()}
        out.update({k: len(v) for k, v in _points.items()})
    return out


def sanitize(values: List[float]) -> List[Any]:
    """Replace non-finite entries with None for strict-JSON export."""
    return [v if math.isfinite(v) else None for v in values]


def reset() -> None:
    with _lock:
        _curves.clear()
        _points.clear()
