"""K3 wrapper: the one-pass column swap and rank-1 update on the card.

Launches the hand-written CUDA kernel in ``csrc/fused_step.cu`` (the
port of `repro.kernels.fused_step.fused_step_pallas`).  The plain
version is `repro_torch.kernels.ref.fused_step_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["fused_step", "launches"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)


def fused_step(a: torch.Tensor, l: torch.Tensor, last: int,
               pc: torch.Tensor, pr: torch.Tensor, col_l: torch.Tensor,
               col_last: torch.Tensor) -> torch.Tensor:
    """``swap_select(a; l <-> last) - outer(pc, pr)`` into a new tensor.

    ``l`` is an int64 tensor on the card (its first element is read by
    the kernel, so the host never waits for the argmax); ``last`` is a
    host int; ``col_l``/``col_last`` are the two pre-swap columns.  For a
    stack ``a (B, M, N)``: ``l (B,)``, one pivot column per matrix, ``pc``,
    ``col_l``, ``col_last`` (B, M) and ``pr`` (B, N), one launch.
    """
    global launches
    _build.require_cuda("fused_step", a, (pc, pr))
    _build.require_cuda("fused_step", a, (col_l, col_last))
    if a.dim() not in (2, 3):
        raise ValueError(f"fused_step: a must be (M, N) or (B, M, N), got "
                         f"{tuple(a.shape)}")
    *lead, m, n = a.shape
    batch = lead[0] if lead else 1
    lead = tuple(lead)
    if (pc.shape != (*lead, m) or pr.shape != (*lead, n)
            or col_l.shape != (*lead, m) or col_last.shape != (*lead, m)):
        raise ValueError(f"fused_step: a={tuple(a.shape)} needs {lead} x "
                         "(M,) pc, col_l, col_last and an (N,) pr")
    if (l.device != a.device or l.dtype != torch.int64
            or not l.is_contiguous()
            or (l.numel() < 1 if not lead else l.shape != lead)):
        raise TypeError("fused_step: l must be an int64 tensor on a's "
                        f"device, one element per matrix ({lead or 1})")
    if not 0 <= last < n:
        raise ValueError(f"fused_step: last={last} outside [0, {n})")
    out = torch.empty_like(a)
    fn = _build.function("fused_step")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(pc.dtype),
                a.data_ptr(), l.data_ptr(), last, pc.data_ptr(),
                pr.data_ptr(), col_l.data_ptr(), col_last.data_ptr(),
                out.data_ptr(), batch, m, n, _build.stream(a))
    _build.check(rc, "fused_step")
    launches += 1
    return out
