"""K4 wrapper: the K-step panel factorization on the card.

Launches the hand-written CUDA kernel in ``csrc/panel_factor.cu`` (the
port of `repro.kernels.panel_factor.panel_factor_pallas`).  The plain
version is `repro_torch.kernels.ref.panel_factor_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["panel_factor", "launches", "MAX_ROWS"]

MAX_ROWS = 1024     # panel rows one launch takes (csrc kMaxRows)
launches = 0        # kernel launches since the last reset (ops.reset_launch_counts)


def panel_factor(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """Factorize a (K, N) panel -> ``(R, ls, sign, logdet)``.

    Same contract as `ref.panel_factor_ref`: ``R`` (K, N) in the panel's
    dtype, ``ls`` (K,) int64, ``sign``/``logdet`` 0-d tensors, all on the
    card, written by one launch.  ``m0`` and ``r_pos`` are host ints.
    """
    global launches
    _build.require_cuda("panel_factor", panel)
    k, n = panel.shape
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"panel_factor: K={k} outside [1, {MAX_ROWS}]")
    if not k <= m0 <= n:
        raise ValueError(f"panel_factor: m0={m0} outside [K={k}, N={n}]")
    r = torch.empty_like(panel)
    ls = torch.empty(k, dtype=torch.int64, device=panel.device)
    sign_logdet = torch.empty(2, dtype=panel.dtype, device=panel.device)
    fn = _build.function("panel_factor")
    with torch.cuda.device(panel.device):
        rc = fn(_build.dtype_code(panel.dtype), panel.data_ptr(),
                r.data_ptr(), ls.data_ptr(), sign_logdet.data_ptr(), k, n,
                int(m0), int(r_pos), _build.stream(panel))
    _build.check(rc, "panel_factor")
    launches += 1
    return r, ls, sign_logdet[0], sign_logdet[1]
