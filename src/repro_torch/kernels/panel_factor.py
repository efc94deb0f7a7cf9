"""K4 wrapper: the K-step panel factorization on the card.

Launches the hand-written CUDA kernel in ``csrc/panel_factor.cu`` (the
port of `repro.kernels.panel_factor.panel_factor_pallas`).  The plain
version is `repro_torch.kernels.ref.panel_factor_ref`.

Bound: step latency (K dependent steps over few bytes).  One launch is
one thread-block cluster whose blocks split the panel's columns and keep
their slices in shared memory for all K steps, exchanging each step's
argmax and pivot column through distributed shared memory, one cluster
barrier a step.  `plan` makes that cut from the shape alone; the C entry
checks and obeys it, and raises (through `_build.check`) when the card
refuses the launch.  A (B, K, N) stack of panels is one launch of B such
clusters, each with the single panel's cut.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["panel_factor", "launches", "plan", "PanelFactorPlan",
           "smem_bytes", "MAX_ROWS", "MAX_CLUSTER", "SMEM_PER_BLOCK"]

MAX_ROWS = 1024        # panel rows one launch takes (csrc kMaxRows)
MAX_CLUSTER = 16       # blocks of the cluster (csrc kMaxCluster; non-portable)
SMEM_PER_BLOCK = 232448  # shared memory one H100 block may opt into
STATIC_SMEM = 1024     # kept back for the kernel's static shared arrays
MIN_COLS = 256         # fewest columns per block: narrow panels take fewer
COL_ALIGN = 32         # columns per block are a multiple of a warp
launches = 0           # kernel launches since the last reset (ops.reset_launch_counts)


class PanelFactorPlan(NamedTuple):
    """How one launch is cut: ``cluster`` blocks, block r owning columns
    ``[r * cols, min((r + 1) * cols, N))``; ``shared`` keeps each slice
    in shared memory (else in R, in global memory); ``smem_bytes`` of
    dynamic shared memory per block (`smem_bytes`)."""
    cluster: int
    cols: int
    shared: bool
    smem_bytes: int


def smem_bytes(k: int, cols: int, itemsize: int, shared: bool) -> int:
    """Dynamic shared memory of one block (csrc/panel_factor.cu): seven
    K-vectors (the copies of the pivot column and the column swapped with
    it; the published candidate column and column ``last``, two parities
    each; the pivots), the K x cols slice if ``shared``, and ``ls`` as K
    ints."""
    return (7 * k + (k * cols if shared else 0)) * itemsize + 4 * k


def _cut(n: int, blocks: int):
    """``(cluster, cols)``: ``n`` columns over at most ``blocks`` blocks,
    each a multiple of `COL_ALIGN` wide, none empty."""
    cols = -(-(-(-n // blocks)) // COL_ALIGN) * COL_ALIGN
    return -(-n // cols), cols


def plan(k: int, n: int, dtype: torch.dtype) -> PanelFactorPlan:
    """The cut of a (k, n) panel in ``dtype``.

    Blocks of at least `MIN_COLS` columns, at most `MAX_CLUSTER` of them;
    if their slices do not fit the shared memory of one block, more
    blocks, up to `MAX_CLUSTER`; if even those do not fit, `MAX_CLUSTER`
    blocks keep their slices in global memory.
    """
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"panel_factor: K={k} outside [1, {MAX_ROWS}]")
    if n < 1:
        raise ValueError(f"panel_factor: N={n} < 1")
    size = dtype.itemsize
    budget = SMEM_PER_BLOCK - STATIC_SMEM
    for blocks in range(min(MAX_CLUSTER, -(-n // MIN_COLS)), MAX_CLUSTER + 1):
        cluster, cols = _cut(n, blocks)
        smem = smem_bytes(k, cols, size, True)
        if smem <= budget:
            return PanelFactorPlan(cluster, cols, True, smem)
    cluster, cols = _cut(n, MAX_CLUSTER)
    return PanelFactorPlan(cluster, cols, False,
                           smem_bytes(k, cols, size, False))


def panel_factor(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """Factorize a (K, N) panel -> ``(R, ls, sign, logdet)``.

    Same contract as `ref.panel_factor_ref`: ``R`` (K, N) in the panel's
    dtype, ``ls`` (K,) int64, ``sign``/``logdet`` 0-d tensors, all on the
    card, written by one cluster launch.  A (B, K, N) stack of panels
    gives ``R`` (B, K, N), ``ls`` (B, K), ``sign``/``logdet`` (B,), one
    launch of B clusters.  ``m0`` and ``r_pos`` are host ints, the same
    for every panel of a stack.
    """
    global launches
    _build.require_cuda("panel_factor", panel)
    if panel.dim() not in (2, 3):
        raise ValueError(f"panel_factor: panel must be (K, N) or (B, K, N), "
                         f"got {tuple(panel.shape)}")
    *lead, k, n = panel.shape
    if not k <= m0 <= n:
        raise ValueError(f"panel_factor: m0={m0} outside [K={k}, N={n}]")
    p = plan(k, n, panel.dtype)
    r = torch.empty_like(panel)
    ls = torch.empty((*lead, k), dtype=torch.int64, device=panel.device)
    sign_logdet = torch.empty((*lead, 2), dtype=panel.dtype,
                              device=panel.device)
    fn = _build.function("panel_factor")
    with torch.cuda.device(panel.device):
        rc = fn(_build.dtype_code(panel.dtype), panel.data_ptr(),
                r.data_ptr(), ls.data_ptr(), sign_logdet.data_ptr(),
                lead[0] if lead else 1, k, n, int(m0), int(r_pos), p.cluster,
                p.cols, int(p.shared), p.smem_bytes, _build.stream(panel))
    _build.check(rc, "panel_factor")
    launches += 1
    return r, ls, sign_logdet[..., 0], sign_logdet[..., 1]
