"""Plain PyTorch versions of the condensation kernels K1-K4.

Each function is the numerical ground truth for one hand-written CUDA
kernel (``kernels/csrc``): the CPU runs these, and ``chip_smoke.py`` holds
every kernel against its plain version on the card, on the same inputs.
They repeat the kernels' arithmetic exactly -- every product is
materialized before it is subtracted, so no multiply-subtract is ever
contracted into an FMA -- which is what makes K1, K3 and K4 bitwise
comparable with them.

Counterparts: `repro.kernels.ref` (K1-K3) and `repro.core.engine
.panel_factor` (K4).
"""
from __future__ import annotations

import torch

__all__ = ["rank1_update_ref", "panel_update_ref", "fused_step_ref",
           "panel_factor_ref", "accumulator_dtype", "guarded_pivot",
           "swap_positions"]


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """The GEMM accumulator of a buffer dtype: f64 for f64, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def guarded_pivot(p: torch.Tensor) -> torch.Tensor:
    """A division-safe pivot: 1 where ``p == 0`` (caller masks the result)."""
    return torch.where(p == 0, torch.ones_like(p), p)


def swap_positions(x: torch.Tensor, dim: int, l: torch.Tensor,
                   last: int) -> None:
    """In place: swap index ``l`` (a (1,) int64 tensor, so the host never
    reads it) with index ``last`` along ``dim``."""
    at_l = x.index_select(dim, l)
    at_last = x.narrow(dim, last, 1).clone()
    x.index_copy_(dim, l, at_last)
    x.narrow(dim, last, 1).copy_(at_l)


def rank1_update_ref(a: torch.Tensor, pc: torch.Tensor,
                     pr: torch.Tensor) -> torch.Tensor:
    """a (M, N) - outer(pc, pr), the product rounded in the operand dtype.

    With bf16 operands the product is a bf16 product, widened to
    ``a.dtype`` before the subtraction.
    """
    return (a - torch.outer(pc, pr)).to(a.dtype)


def panel_update_ref(a: torch.Tensor, c: torch.Tensor,
                     r: torch.Tensor) -> torch.Tensor:
    """a (M, N) - c (M, K) @ r (K, N), accumulated in f32 (f64 for f64).

    Follows the Pallas kernel (`repro.kernels.panel_update`), not the
    jnp oracle: bf16 operands are widened before the product, so the
    contraction never rounds to bf16.
    """
    acc = accumulator_dtype(a.dtype)
    return a - (c.to(acc) @ r.to(acc)).to(a.dtype)


def fused_step_ref(a: torch.Tensor, l, last: int, pc: torch.Tensor,
                   pr: torch.Tensor, col_l: torch.Tensor,
                   col_last: torch.Tensor) -> torch.Tensor:
    """Column swap (l <-> last) and rank-1 update as one select pass.

    ``l`` may be a 0-d device tensor.  Bitwise equal to the scatter swap
    followed by `rank1_update_ref`: the swap moves data, the
    multiply-subtract is the same arithmetic.
    """
    cols = torch.arange(a.shape[1], device=a.device)
    sw = torch.where(cols[None, :] == l, col_last[:, None],
                     torch.where(cols[None, :] == last, col_l[:, None], a))
    return sw - (pc[:, None] * pr[None, :]).to(a.dtype)


def panel_factor_ref(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """Factorize a (K, N) condensation panel: K sequential steps.

    Live columns before the panel are ``[0, m0)``; ``r_pos`` counts the
    live rows above the panel (sign parity only).  Returns
    ``(R, ls, sign, logdet)``: the normalized pivot rows in the final
    swapped coordinates, the (K,) int64 pivot column chosen at each step
    (in that step's coordinates), and the panel's contribution to the
    sign and log|det| as 0-d tensors.  The input is not modified.
    """
    k_rows, n = panel.shape
    dt = panel.dtype
    buf = panel.clone()
    rows = torch.arange(k_rows, device=panel.device)
    ls = torch.zeros(k_rows, dtype=torch.int64, device=panel.device)
    one = torch.ones((), dtype=dt, device=panel.device)
    sign = one
    logdet = torch.zeros((), dtype=dt, device=panel.device)
    for k in range(k_rows):
        m = m0 - k
        last = m - 1
        l = buf[k, :m].abs().argmax().view(1)
        pv = buf[k].index_select(0, l)[0]
        swap_positions(buf, 1, l, last)
        row = buf[k]
        pr = torch.where(pv == 0, torch.zeros_like(row),
                         row / guarded_pivot(pv))
        pr[last] = torch.where(pv == 0, pr[last], one)
        buf[k] = pr
        pc = torch.where(rows <= k, 0.0, buf[:, last]).to(dt)
        buf = buf - torch.outer(pc, pr)
        ls[k] = l[0]
        parity = 1.0 if (r_pos + m - 1) % 2 == 0 else -1.0
        swap_sign = torch.where(l[0] == last, 1.0, -1.0).to(dt)
        sign = sign * torch.sign(pv) * swap_sign * parity
        logdet = logdet + torch.log(torch.abs(pv))
    return buf, ls, sign, logdet
