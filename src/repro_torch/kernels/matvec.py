"""K5 wrapper: the skinny product ``a @ x`` of a rank's row block.

Launches the hand-written CUDA kernel in ``csrc/matvec.cu`` (the port of
`repro.kernels.matvec.matvec_pallas`), the local product of every
`repro_torch.estimators.ShardedOperator` product.  The plain version is
`repro_torch.kernels.ref.matvec_ref`; the two sum in another order, so
they agree within `ref.matvec_bound`.

Bound: bytes (A once).  Up to four columns a warp streams each row of A
and reduces with shuffles; wider slabs take the tile of
``csrc/skinny_mma.cuh`` (128 rows x up to 64 columns per block, A
streamed through a shared-memory ring by the copy engine), with the
reduction axis split when the tiles alone would leave the card short of
blocks.  `plan` makes that cut; the C entry checks and obeys it.  The
partials of a split call are allocated here, through PyTorch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["matvec", "launches", "plan", "MatvecPlan"]

launches = 0    # kernel launches since the last reset (ops.reset_launch_counts)

MAX_GEMV_COLS = 4     # k up to this takes the warp-per-row path
GEMV_ROWS = 8         # rows (warps) per block there
BLOCK_ROWS = 128      # rows per block of the tile path (skinny_mma.cuh)
MAX_BLOCK_COLS = 64   # columns per block of the tile path; more take blocks
SPLIT_ALIGN = 32      # a range of the reduction axis is a multiple of this
BLOCKS_PER_SM = 2     # tile blocks resident on one SM (registers, smem)
CHUNK_BYTES = 256     # bytes of each row of A per pipeline stage


class MatvecPlan(NamedTuple):
    """How one call is cut: blocks of ``bm`` rows and ``bn`` columns
    (``col_blocks`` of them across k), A streamed ``chunk`` columns per
    stage, the reduction axis in ``splits`` ranges of ``split_len``
    columns (the last may be shorter), and ``workspace`` elements of an
    (splits, m, k) partials buffer (0 with one range)."""
    bm: int
    bn: int
    col_blocks: int
    chunk: int
    splits: int
    split_len: int
    workspace: int


def plan(m: int, n: int, k: int, dtype: torch.dtype, sms: int) -> MatvecPlan:
    """The cut of ``a (m, n) @ x (n, k)`` in ``dtype`` on a card of ``sms``
    SMs.

    k <= 4: one warp per row, nothing split.  Otherwise ``bn`` is the
    smallest of 16, 32, 64 that holds k (64 above it, in column blocks),
    and the reduction axis is split into the most equal 32-aligned ranges
    whose grid still fits ``BLOCKS_PER_SM`` blocks on every SM at once:
    a short grid gets enough blocks to keep every SM streaming, and none
    waits for a second round.
    """
    if k <= MAX_GEMV_COLS:
        return MatvecPlan(GEMV_ROWS, k, 1, 0, 1, max(n, 1), 0)
    bn = 16 if k <= 16 else 32 if k <= 32 else MAX_BLOCK_COLS
    col_blocks = -(-k // bn)
    tiles = max(1, -(-m // BLOCK_ROWS) * col_blocks)
    chunk = CHUNK_BYTES // dtype.itemsize
    align = max(SPLIT_ALIGN, chunk)         # whole stages, 32-aligned
    pieces = -(-n // align)
    splits = max(1, min(pieces, BLOCKS_PER_SM * sms // tiles))
    split_len = max(1, -(-pieces // splits)) * align
    splits = max(1, -(-n // split_len))
    return MatvecPlan(BLOCK_ROWS, bn, col_blocks, chunk, splits, split_len,
                      splits * m * k if splits > 1 else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    p = plan(m, n, k, a.dtype, _sm_count(a.device.index))
    partials = (torch.empty(p.workspace, dtype=a.dtype, device=a.device)
                if p.workspace else None)
    fn = _build.function("matvec")
    with torch.cuda.device(a.device):
        rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), x2.data_ptr(),
                o.data_ptr(), None if partials is None else
                partials.data_ptr(), m, n, k, p.bm, p.bn, p.chunk, p.splits,
                p.split_len, _build.stream(a))
    _build.check(rc, "matvec")
    launches += 1
    return o[:, 0] if x.dim() == 1 else o
