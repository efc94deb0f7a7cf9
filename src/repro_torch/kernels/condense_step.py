"""K1 wrapper: the rank-1 condensation update on the card.

Launches the hand-written CUDA kernel in ``csrc/condense_step.cu``
(the port of `repro.kernels.condense_step.rank1_update_pallas`).  The
plain version is `repro_torch.kernels.ref.rank1_update_ref`; CPU tensors
reach it through `repro_torch.kernels.ops`, never through this module.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["rank1_update", "launches"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)


def rank1_update(a: torch.Tensor, pc: torch.Tensor,
                 pr: torch.Tensor) -> torch.Tensor:
    """``a (M, N) - outer(pc (M,), pr (N,))`` into a new tensor, or for a
    stack ``a (B, M, N)`` with ``pc (B, M)``, ``pr (B, N)`` the same per
    matrix, in one launch.

    ``a`` is f32 or f64; ``pc`` and ``pr`` are in ``a.dtype`` or both
    bf16 (then the product rounds to bf16 before it is widened).  A
    stack's matrices may lie any distance apart (each contiguous); the
    output is contiguous.
    """
    global launches
    _build.require_cuda("rank1_update", a, (pc, pr), batch_stride=True)
    if a.dim() == 2:
        (m, n), batch, stride = a.shape, 1, a.numel()
    elif a.dim() == 3:
        batch, m, n = a.shape
        stride = a.stride(0) if batch > 1 else m * n
    else:
        raise ValueError(f"rank1_update: a must be (M, N) or (B, M, N), got "
                         f"{tuple(a.shape)}")
    lead = tuple(a.shape[:-2])
    if pc.shape != (*lead, m) or pr.shape != (*lead, n):
        raise ValueError(f"rank1_update: a={tuple(a.shape)} needs pc "
                         f"{(*lead, m)} and pr {(*lead, n)}, got "
                         f"{tuple(pc.shape)}, {tuple(pr.shape)}")
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    fn = _build.function("rank1_update")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(pc.dtype),
                a.data_ptr(), pc.data_ptr(), pr.data_ptr(), out.data_ptr(),
                batch, m, n, stride, _build.stream(a))
    _build.check(rc, "rank1_update")
    launches += 1
    return out
