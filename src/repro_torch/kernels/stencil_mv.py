"""K8 wrapper: the banded product of a stencil operator on the card.

Launches the hand-written CUDA kernel in ``csrc/stencil_mv.cu`` (the
port of `repro.kernels.stencil_mv.stencil_mv_pallas`).  The plain
version is `repro_torch.kernels.ref.stencil_mv_ref`, which the kernel
equals bit for bit.

Bound: bytes (one multiply-add per band entry against a read of x).  One
thread per row and 16-byte vector of columns streams the slab once; the
rows a band reaches outside ``[0, n)`` read zeros by a bounds check,
where the Pallas kernel pads a copy of x.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["stencil_mv", "launches", "MAX_BANDS"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)
MAX_BANDS = 16  # REPRO_MAX_BANDS in csrc/repro_kernels.cuh


def stencil_mv(bands: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """``y[i] = sum_d bands[d, i] * x[i + offsets[d]]`` into a new tensor.

    ``bands (nb, n)``; ``x (n,)`` or ``(n, k)`` in the bands' dtype;
    ``offsets`` nb distinct host ints in ``(-n, n)``.  Reads outside
    ``[0, n)`` are zero.
    """
    global launches
    _build.require_cuda("stencil_mv", bands, (x,))
    if x.dtype != bands.dtype:
        raise TypeError(f"stencil_mv: x must be {bands.dtype}, got {x.dtype}")
    offsets = tuple(int(o) for o in offsets)
    nb, n = bands.shape if bands.dim() == 2 else (-1, -1)
    if nb != len(offsets) or not 1 <= nb <= MAX_BANDS:
        raise ValueError(f"stencil_mv: bands {tuple(bands.shape)} need one "
                         f"row per offset, 1 to {MAX_BANDS}, got {offsets}")
    if x.dim() not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"stencil_mv: x must be ({n},) or ({n}, k), got "
                         f"{tuple(x.shape)}")
    if any(abs(o) >= n for o in offsets):
        raise ValueError(f"stencil_mv: offsets {offsets} out of range for "
                         f"n={n}")
    k = 1 if x.dim() == 1 else x.shape[1]
    y = torch.empty_like(x)
    fn = _build.function("stencil_mv")
    offs = (ctypes.c_longlong * nb)(*offsets)
    with torch.cuda.device(bands.device):
        rc = fn(_build.dtype_code(bands.dtype), bands.data_ptr(), offs, nb,
                x.data_ptr(), y.data_ptr(), n, k, _build.stream(bands))
    _build.check(rc, "stencil_mv")
    launches += 1
    return y
