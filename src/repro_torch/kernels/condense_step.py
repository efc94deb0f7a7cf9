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
    """``a (M, N) - outer(pc (M,), pr (N,))`` into a new tensor.

    ``a`` is f32 or f64; ``pc`` and ``pr`` are in ``a.dtype`` or both
    bf16 (then the product rounds to bf16 before it is widened).
    """
    global launches
    _build.require_cuda("rank1_update", a, (pc, pr))
    m, n = a.shape
    if pc.shape != (m,) or pr.shape != (n,):
        raise ValueError(f"rank1_update: a={tuple(a.shape)} needs pc ({m},) "
                         f"and pr ({n},), got {tuple(pc.shape)}, "
                         f"{tuple(pr.shape)}")
    out = torch.empty_like(a)
    fn = _build.function("rank1_update")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), _build.dtype_code(pc.dtype),
                a.data_ptr(), pc.data_ptr(), pr.data_ptr(), out.data_ptr(),
                m, n, _build.stream(a))
    _build.check(rc, "rank1_update")
    launches += 1
    return out
