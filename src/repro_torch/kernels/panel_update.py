"""K2 wrapper: the trailing panel update ``a - c @ r`` on the card.

Launches the hand-written CUDA kernel in ``csrc/panel_update.cu`` (the
port of `repro.kernels.panel_update.panel_update_pallas`).  The plain
version is `repro_torch.kernels.ref.panel_update_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["panel_update", "launches"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)


def panel_update(a: torch.Tensor, c: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """``a (M, N) - c (M, K) @ r (K, N)`` into a new tensor.

    The product accumulates in f32 (f64 for an f64 ``a``) with full-
    precision FMAs; bf16 ``c`` and ``r`` are widened on load.
    """
    global launches
    _build.require_cuda("panel_update", a, (c, r))
    m, n = a.shape
    k = c.shape[1] if c.dim() == 2 else -1
    if c.shape != (m, k) or r.shape != (k, n):
        raise ValueError(f"panel_update: shape mismatch a={tuple(a.shape)} "
                         f"c={tuple(c.shape)} r={tuple(r.shape)}")
    out = torch.empty_like(a)
    fn = _build.function("panel_update")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(c.dtype),
                a.data_ptr(), c.data_ptr(), r.data_ptr(), out.data_ptr(),
                m, n, k, _build.stream(a))
    _build.check(rc, "panel_update")
    launches += 1
    return out
