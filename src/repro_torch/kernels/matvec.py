"""K5 wrapper: the skinny product ``a @ x`` of a rank's row block.

Launches the hand-written CUDA kernel in ``csrc/matvec.cu`` (the port of
`repro.kernels.matvec.matvec_pallas`), the local product of every
`repro_torch.estimators.ShardedOperator` product.  The plain version is
`repro_torch.kernels.ref.matvec_ref`; the two sum in another order, so
they agree within `ref.matvec_bound`.

Bound: bytes (A once).  Up to four columns a warp streams each row of A
and reduces with shuffles; wider slabs take the skinny GEMM tile of K6/K7
on the rectangular block.  Reads past the edges are bounds-checked where
the Pallas kernel pads a copy of A.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["matvec", "launches"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a (m, n) @ x (n,) or (n, k)`` into a new tensor in ``a``'s dtype;
    ``x`` is cast to it first."""
    global launches
    if a.dim() != 2 or x.dim() not in (1, 2) or x.shape[0] != a.shape[1]:
        raise ValueError(f"matvec: need a (m, n) and x (n,) or (n, k), got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    x2 = (x[:, None] if x.dim() == 1 else x).to(a.dtype).contiguous()
    _build.require_cuda("matvec", a, (x2,))
    m, n = a.shape
    k = x2.shape[1]
    o = torch.empty((m, k), dtype=a.dtype, device=a.device)
    fn = _build.function("matvec")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), x2.data_ptr(),
                o.data_ptr(), m, n, k, _build.stream(a))
    _build.check(rc, "matvec")
    launches += 1
    return o[:, 0] if x.dim() == 1 else o
