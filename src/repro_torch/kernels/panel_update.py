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
    """``a (M, N) - c (M, K) @ r (K, N)`` into a new tensor, or for a stack
    ``a (B, M, N)``, ``c (B, M, K)``, ``r (B, K, N)`` the same per matrix,
    in one launch.

    The product accumulates in f32 (f64 for an f64 ``a``) with full-
    precision FMAs; bf16 ``c`` and ``r`` are widened on load.
    """
    global launches
    _build.require_cuda("panel_update", a, (c, r))
    if a.dim() not in (2, 3):
        raise ValueError(f"panel_update: a must be (M, N) or (B, M, N), got "
                         f"{tuple(a.shape)}")
    *lead, m, n = a.shape
    lead = tuple(lead)
    k = c.shape[-1] if c.dim() == a.dim() else -1
    if c.shape != (*lead, m, k) or r.shape != (*lead, k, n):
        raise ValueError(f"panel_update: shape mismatch a={tuple(a.shape)} "
                         f"c={tuple(c.shape)} r={tuple(r.shape)}")
    out = torch.empty_like(a)
    fn = _build.function("panel_update")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(c.dtype),
                a.data_ptr(), c.data_ptr(), r.data_ptr(), out.data_ptr(),
                lead[0] if lead else 1, m, n, k, _build.stream(a))
    _build.check(rc, "panel_update")
    launches += 1
    return out
