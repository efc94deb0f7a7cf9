"""Kernel entry points, dispatched by the tensor's device.

Counterpart of `repro.kernels.ops`.  There is no backend switch: a CUDA
tensor launches the hand-written kernel (and raises if it cannot), a CPU
tensor takes the plain PyTorch version in `kernels.ref`, any other device
raises.  No path sends a CUDA tensor to a plain version, so a launch
count of zero on the card means the path did not run.

The engine (core/engine.py) calls these four operations and
`fused_condense_step`; the O(n) pivot bookkeeping around the rank-1
kernels (`pivot_operands`) stays in PyTorch on the tensor's device, with
no host synchronization.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import condense_step as _k1
from repro_torch.kernels import fused_step as _k3
from repro_torch.kernels import panel_factor as _k4
from repro_torch.kernels import panel_update as _k2
from repro_torch.kernels import ref as _ref

__all__ = ["rank1_update", "panel_update", "fused_condense_step",
           "panel_factor", "pivot_operands", "launch_counts",
           "reset_launch_counts", "KERNELS"]

# kernel name -> wrapper module holding its launch counter
KERNELS = {"rank1_update": _k1, "panel_update": _k2, "fused_step": _k3,
           "panel_factor": _k4}


def launch_counts() -> dict:
    """Kernel launches on the card since the last reset, by kernel name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device "
                     f"{t.device} (cuda or cpu)")


def _quantize(precision: Optional[str], *operands):
    """Cast multiply operands for a mixed-precision route.

    ``precision="bf16"`` quantizes them to bfloat16; every kernel and
    plain version widens the product back to the buffer dtype, so the
    sign / parity / log accumulators never leave full precision.
    """
    if precision is None:
        return operands
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}; "
                         "one of (None, 'bf16')")
    return tuple(o.to(torch.bfloat16) for o in operands)


def rank1_update(a: torch.Tensor, pc: torch.Tensor, pr: torch.Tensor, *,
                 precision: Optional[str] = None) -> torch.Tensor:
    """``a - outer(pc, pr)`` (K1 on the card)."""
    pc, pr = _quantize(precision, pc, pr)
    if _on_card(a, "rank1_update"):
        return _k1.rank1_update(a, pc, pr)
    return _ref.rank1_update_ref(a, pc, pr)


def panel_update(a: torch.Tensor, c: torch.Tensor, r: torch.Tensor, *,
                 precision: Optional[str] = None) -> torch.Tensor:
    """``a - c @ r`` (K2 on the card)."""
    c, r = _quantize(precision, c, r)
    if _on_card(a, "panel_update"):
        return _k2.panel_update(a, c, r)
    return _ref.panel_update_ref(a, c, r)


def panel_factor(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """K-step panel factorization -> ``(R, ls, sign, logdet)`` (K4)."""
    if _on_card(panel, "panel_factor"):
        return _k4.panel_factor(panel, m0, r_pos)
    return _ref.panel_factor_ref(panel, m0, r_pos)


def pivot_operands(buf: torch.Tensor, t: int):
    """The O(n) bookkeeping of condensation step ``t`` (§2.2-§2.4).

    The pivot is the max-abs entry of the live part ``[0, n - t)`` of row
    ``t``; it is swapped to column ``last = n - t - 1``.  Returns
    ``(l, p, pc, pr, col_l, col_last)``: the pivot column as a (1,)
    int64 tensor, the pivot value (0-d), the pivot column zeroed at rows
    ``<= t``, the pivot row in swapped coordinates normalized so that
    ``pr[last] == 1`` (all zero for a zero pivot), and the two pre-swap
    columns.  Everything stays on ``buf``'s device.
    """
    n = buf.shape[0]
    last = n - t - 1
    row = buf[t]
    l = row[:last + 1].abs().argmax().view(1)
    p = row.index_select(0, l)[0]
    col_l = buf.index_select(1, l)[:, 0]
    col_last = buf[:, last].clone()
    row = row.clone()
    row.index_copy_(0, l, buf[t, last:last + 1])
    row[last] = p
    pr = torch.where(p == 0, torch.zeros_like(row),
                     row / _ref.guarded_pivot(p))
    pc = col_l.clone()
    pc[:t + 1] = 0
    return l, p, pc, pr, col_l, col_last


def fused_condense_step(buf: torch.Tensor, t: int, *,
                        precision: Optional[str] = None):
    """One-pass condensation step at pivot row ``t`` -> ``(buf', l, p)``.

    The O(n) bookkeeping runs in PyTorch (`pivot_operands`); the O(n^2)
    column swap and rank-1 update are one pass (K3 on the card), bitwise
    equal to the scatter swap followed by `rank1_update`.  ``buf`` is not
    modified.
    """
    l, p, pc, pr, col_l, col_last = pivot_operands(buf, t)
    pc, pr = _quantize(precision, pc, pr)
    last = buf.shape[0] - t - 1
    if _on_card(buf, "fused_step"):
        out = _k3.fused_step(buf, l, last, pc, pr, col_l, col_last)
    else:
        out = _ref.fused_step_ref(buf, l, last, pc, pr, col_l, col_last)
    return out, l, p
