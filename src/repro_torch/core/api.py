"""The determinant-preserving padding the plans use.

Counterpart of `repro.core.api.pad_to_multiple`.  The deprecated string
API around it (``slogdet``, ``logdet``, ``logdet_batched``) is not ported
yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch

__all__ = ["pad_to_multiple"]


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
