"""Kernel entry points, dispatched by the tensor's device.

Counterpart of `repro.kernels.ops`.  There is no backend switch: a CUDA
tensor launches the hand-written kernel (and raises if it cannot), a CPU
tensor takes the plain PyTorch version in `kernels.ref`, any other device
raises.  No path sends a CUDA tensor to a plain version, so a launch
count of zero on the card means the path did not run.

The engine (core/engine.py) calls the four condensation operations and
`fused_condense_step`; the O(n) pivot bookkeeping around the rank-1
kernels (`pivot_operands`) stays in PyTorch on the tensor's device, with
no host synchronization.  Each takes one matrix or a (B, n, n) stack: a
stack is one launch of the kernel's batch grid (the port of what `vmap`
does to the JAX package's kernels) and one set of PyTorch ops, never a
loop over its matrices.  The estimators call `fused_cheb_step` (dense
Chebyshev), `fused_cg_step` (dense CG), `stencil_mv` (every
`StencilOperator` product) and `matvec` (the local product of every
`ShardedOperator` product).

Observability, with the JAX package's names: every entry counts a
``kernel.dispatch`` (labels ``op`` and ``backend``: ``"cuda"`` for a
kernel launch, ``"torch"`` for the CPU's plain version) and runs inside a
``kernel.<op>`` stage (`repro_torch.obs`); K4's keeps the JAX package's
``panel_factor_vmem``.  Both are no-ops with obs off.  `launch_counts`
is separate: it counts launches on the card in every mode.

Static analysis (`repro_torch.analysis`): every entry reports itself to
the active op recorder as ``kernel.<name>`` (the `launch_counts` names)
with the operands it hands the kernel or its plain version.  With no
recorder that is one ``is None`` test.

Deliberate difference from `repro.kernels.ops`: the JAX package sends
K6/K7 operands above an 8 MiB VMEM budget, and batched ``a.ndim == 3``
operands, to the jnp reference.  Here a CUDA tensor runs K6/K7 at every n,
and a batched operand raises `ValueError`: a stack runs as a
`BatchedOperator`, whose products never reach K6/K7, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs as _obs
from repro_torch.kernels import condense_step as _k1
from repro_torch.kernels import fused_est as _k67
from repro_torch.kernels import fused_step as _k3
from repro_torch.kernels import matvec as _k5
from repro_torch.kernels import panel_factor as _k4
from repro_torch.kernels import panel_update as _k2
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import stencil_mv as _k8

__all__ = ["rank1_update", "panel_update", "fused_condense_step",
           "panel_factor", "pivot_operands", "matvec", "fused_cheb_step",
           "fused_cg_step", "stencil_mv", "launch_counts",
           "reset_launch_counts", "KERNELS"]

# kernel name -> (wrapper module, name of its launch counter there)
KERNELS = {"rank1_update": (_k1, "launches"),
           "panel_update": (_k2, "launches"),
           "fused_step": (_k3, "launches"),
           "panel_factor": (_k4, "launches"),
           "matvec": (_k5, "launches"),
           "cheb_step": (_k67, "cheb_step_launches"),
           "cg_step": (_k67, "cg_step_launches"),
           "stencil_mv": (_k8, "launches")}


def launch_counts() -> dict:
    """Kernel launches on the card since the last reset, by kernel name."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


# the active `repro_torch.analysis.ir.Recorder`, set while one records
_recorder = None
# a dispatch op's name -> its kernel's name in KERNELS
_KERNEL_OF = {"panel_factor_vmem": "panel_factor",
              "fused_condense_step": "fused_step",
              "fused_cheb_step": "cheb_step", "fused_cg_step": "cg_step"}


def _on_card(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device "
                     f"{t.device} (cuda or cpu)")


def _dispatch(t: torch.Tensor, op: str, stage: str, operands: tuple):
    """``(card, stage)``: whether ``t`` launches the kernel (`_on_card`),
    and the ``stage`` to run it in; the ``kernel.dispatch`` counter of
    ``op`` is counted (backend ``cuda`` or ``torch``), and the entry,
    with its ``operands``, is reported to an active recorder."""
    card = _on_card(t, op)
    if _recorder is not None:
        _recorder.kernel(_KERNEL_OF.get(op, op), operands)
    backend = "cuda" if card else "torch"
    _obs.inc("kernel.dispatch", op=op, backend=backend)
    return card, _obs.stage(stage, backend=backend)


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
    card, stage = _dispatch(a, "rank1_update", "kernel.rank1_update",
                            (a, pc, pr))
    with stage:
        if card:
            return _k1.rank1_update(a, pc, pr)
        return _ref.rank1_update_ref(a, pc, pr)


def panel_update(a: torch.Tensor, c: torch.Tensor, r: torch.Tensor, *,
                 precision: Optional[str] = None) -> torch.Tensor:
    """``a - c @ r`` (K2 on the card)."""
    c, r = _quantize(precision, c, r)
    card, stage = _dispatch(a, "panel_update", "kernel.panel_update",
                            (a, c, r))
    with stage:
        if card:
            return _k2.panel_update(a, c, r)
        return _ref.panel_update_ref(a, c, r)


def panel_factor(panel: torch.Tensor, m0: int, r_pos: int = 0):
    """K-step panel factorization -> ``(R, ls, sign, logdet)`` (K4); a
    stack's panels (B, K, N), a strided view of its rows, are gathered
    into one contiguous operand first."""
    if panel.dim() == 3:
        panel = panel.contiguous()
    card, stage = _dispatch(panel, "panel_factor_vmem",
                            "kernel.panel_factor_vmem", (panel,))
    with stage:
        if card:
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
    columns.  For a (B, n, n) stack, each matrix's own: ``l`` and ``p``
    (B,), the vectors (B, n), first-index ties as ``argmax``.  Everything
    stays on ``buf``'s device.
    """
    if buf.dim() == 3:
        return _pivot_operands_stack(buf, t)
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


def _pivot_operands_stack(buf: torch.Tensor, t: int):
    b, n = buf.shape[0], buf.shape[-1]
    last = n - t - 1
    row = buf[:, t]
    l = row[:, :last + 1].abs().argmax(-1)                     # (B,)
    p = row.gather(1, l[:, None])[:, 0]                        # (B,)
    col_l = buf.gather(2, l[:, None, None].expand(b, n, 1))[..., 0]
    col_last = buf[:, :, last].clone()
    row = row.clone()
    row.scatter_(1, l[:, None], buf[:, t, last:last + 1])
    row[:, last] = p
    pr = torch.where(p[:, None] == 0, torch.zeros_like(row),
                     row / _ref.guarded_pivot(p)[:, None])
    pc = col_l.clone()
    pc[:, :t + 1] = 0
    return l, p, pc, pr, col_l, col_last


def fused_condense_step(buf: torch.Tensor, t: int, *,
                        precision: Optional[str] = None):
    """One-pass condensation step at pivot row ``t`` -> ``(buf', l, p)``.

    The O(n) bookkeeping runs in PyTorch (`pivot_operands`); the O(n^2)
    column swap and rank-1 update are one pass (K3 on the card), bitwise
    equal to the scatter swap followed by `rank1_update`.  ``buf`` is not
    modified; on a stack ``l`` and ``p`` are (B,).
    """
    l, p, pc, pr, col_l, col_last = pivot_operands(buf, t)
    pc, pr = _quantize(precision, pc, pr)
    card, stage = _dispatch(buf, "fused_condense_step", "kernel.fused_step",
                            (buf, l, pc, pr, col_l, col_last))
    last = buf.shape[-1] - t - 1
    with stage:
        if card:
            out = _k3.fused_step(buf, l, last, pc, pr, col_l, col_last)
        else:
            out = _ref.fused_step_ref(buf, l, last, pc, pr, col_l, col_last)
    return out, l, p


def _unbatched(op: str, a: torch.Tensor) -> None:
    if a.dim() != 2:
        raise ValueError(
            f"{op}: takes one (n, n) matrix, got {tuple(a.shape)}; a (B, n, "
            "n) stack runs as a BatchedOperator, whose products are batched "
            "matmuls")


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a (m, n) @ x (n,) or (n, k)``, ``x`` cast to ``a``'s dtype (K5 on
    the card)."""
    card, stage = _dispatch(a, "matvec", "kernel.matvec", (a, x))
    with stage:
        if card:
            return _k5.matvec(a, x)
        return _ref.matvec_ref(a, x)


def fused_cheb_step(a: torch.Tensor, w: torch.Tensor, w_prev: torch.Tensor,
                    v: torch.Tensor, center, width):
    """One Chebyshev three-term step, one pass over ``a`` -> ``(w_next,
    dots)`` (K6 on the card).

    ``w_next = 2 (2 a w - center w) / width - w_prev`` and ``dots = (v *
    w_next).sum(-2)``.  On the card ``center`` and ``width`` must be
    one-element tensors there; on the CPU they may be numbers.
    """
    _unbatched("fused_cheb_step", a)
    card, stage = _dispatch(a, "fused_cheb_step",
                            "kernel.fused_cheb_step", (a, w, w_prev, v))
    with stage:
        if card:
            return _k67.cheb_step(a, w, w_prev, v, center, width)
        return _ref.cheb_step_ref(a, w, w_prev, v, center, width)


def fused_cg_step(a: torch.Tensor, p: torch.Tensor, x: torch.Tensor,
                  r: torch.Tensor, rz: torch.Tensor):
    """One CG matvec-and-axpy chain, one pass over ``a`` -> ``(x_new,
    r_new)`` (K7 on the card): ``ap = a p; alpha = rz / (p . ap)``
    (guarded 0/0 -> 0), ``x + alpha p``, ``r - alpha ap``."""
    _unbatched("fused_cg_step", a)
    card, stage = _dispatch(a, "fused_cg_step", "kernel.fused_cg_step",
                            (a, p, x, r, rz))
    with stage:
        if card:
            return _k67.cg_step(a, p, x, r, rz)
        return _ref.cg_step_ref(a, p, x, r, rz)


def stencil_mv(bands: torch.Tensor, x: torch.Tensor, *,
               offsets) -> torch.Tensor:
    """Banded product ``y[i] = sum_d bands[d, i] * x[i + offsets[d]]``,
    zero outside ``[0, n)``, for ``x (n,)`` or ``(n, k)`` (K8 on the
    card)."""
    card, stage = _dispatch(bands, "stencil_mv", "kernel.stencil_mv",
                            (bands, x))
    with stage:
        if card:
            return _k8.stencil_mv(bands, x, offsets)
        return _ref.stencil_mv_ref(bands, x, offsets=offsets)
