"""The result type every `repro_torch` plan returns.

Counterpart of `repro.core.result`.  ``sign`` and ``logabsdet`` follow
``numpy.linalg.slogdet`` semantics and are 0-d tensors on the device the
plan ran on.  Tuple unpacking is supported::

    sign, logabsdet = plan(a)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

__all__ = ["LogdetResult", "Diagnostics"]


@dataclass(frozen=True)
class Diagnostics:
    """Where the time went and what the plan actually executed.

    ``matvec_cols``   operator matvec columns of an estimator pass; None
                      for exact methods, whose cost is ``flops_est``.
    ``flops_est``     dense-equivalent FLOP estimate of the path.
    ``cg_iters``      CG iterations of the backward solve of an
                      estimator's ``value_and_grad`` (else None).
    ``wall_time_s``   host wall time of this execution, taken after
                      ``torch.cuda.synchronize()`` on the card.
    ``padded_n``      problem size after `pad_to_multiple` embedding.
    ``device_count``  devices the execution spanned.
    ``convergence``   convergence telemetry of this execution under
                      ``REPRO_OBS=trace`` (`repro_torch.obs`), else None.
    """
    matvec_cols: Optional[int] = None
    flops_est: Optional[float] = None
    cg_iters: Optional[int] = None
    wall_time_s: Optional[float] = None
    padded_n: Optional[int] = None
    device_count: int = 1
    convergence: Optional[Dict[str, List[float]]] = field(
        default=None, compare=False)


@dataclass(frozen=True)
class LogdetResult:
    """Sign, log|det|, uncertainty and provenance of one plan execution.

    ``sem`` is the standard error of an estimator and exactly zero for
    exact methods.
    """
    sign: torch.Tensor
    logabsdet: torch.Tensor
    sem: torch.Tensor
    method_used: str
    diagnostics: Diagnostics

    def __iter__(self):
        """Unpack like the legacy pair: ``sign, logabsdet = result``."""
        return iter((self.sign, self.logabsdet))

    def __repr__(self):
        return (f"LogdetResult(sign={self.sign}, "
                f"logabsdet={self.logabsdet}, sem={self.sem}, "
                f"method_used={self.method_used!r})")
