"""The condensation engine in PyTorch: serial and staged schedules.

Counterpart of `repro.core.engine`: one implementation of the paper's
step -- pivot-column argmax (§2.2), row normalization (§2.3), column swap
(§2.4) -- over two axes:

  schedule   "serial"  one buffer, one rank per step
             "staged"  geometric stages over shrinking buffers
  update     "rank1"   the outer-product subtract (kernel K1, or K3 fused)
             "panel"   K-row panels: factorize K rows (K4), then ONE
                       trailing GEMM (K2)

plus ``fused=True`` (one-pass steps, one composed-permutation gather per
panel) and ``precision="bf16"`` (bf16 multiply operands, full-precision
buffer and accumulators).  The mesh schedule and ``lookahead`` are not
ported yet (ROADMAP Queue 1 item 8).

Each step is a Python loop iteration over device work: no ``.item()``,
``float()`` or ``bool()`` of a device tensor inside the loops, so the
host only waits when the caller reads the result.  Every kernel-shaped
operation goes through `repro_torch.kernels.ops`, which launches the CUDA
kernel for a CUDA tensor and the plain version for a CPU tensor.  Unlike
the JAX package, which runs its unfused native-precision rank-1 stages
inline in jnp even with a kernel backend, every rank-1 update here goes
through K1 (or K3): the arithmetic is the same, and no plain version runs
on the card's main path.

Buffers: every public entry point copies its input once and never modifies
the caller's tensor; later buffers are the engine's own and are updated
in place (the column swaps) or replaced by kernel outputs.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import guarded_pivot, swap_positions

__all__ = [
    "EngineConfig", "SCHEDULES", "UPDATES", "BACKENDS", "build_serial",
    "condense_steps", "condense_full", "panel_factor", "apply_panel",
    "panel_rounds_serial", "blocked_full", "staged_full", "stage_schedule",
    "combine_slogdet", "guarded_pivot",
]

SCHEDULES = ("serial", "staged", "mesh")
UPDATES = ("rank1", "panel")
# the kernel follows the tensor's device (kernels/ops.py), so the only
# backend is "auto"
BACKENDS = ("auto",)

_MESH_TODO = ("the mesh schedule and lookahead are not ported to "
              "repro_torch yet (ROADMAP Queue 1 item 8)")


@dataclass(frozen=True)
class EngineConfig:
    """One point in the schedule x update design space.

    ``panel_k``   panel width of the rank-K update (ignored for rank1).
    ``shrink``    geometric stage ratio of the staged schedule.
    ``min_size``  size below which the staged schedule stops staging.
    ``lookahead`` mesh-only pipelining (not ported: ROADMAP Queue 1 item 8).
    ``fused``     serial/staged-only: one-pass condensation steps (K3)
                  and one composed-permutation gather per panel instead
                  of K column swaps; bit-identical results.
    ``precision`` ``None`` (native) or ``"bf16"``: quantize the GEMM /
                  outer-product operands to bfloat16; the buffer and all
                  sign/parity/log accumulators keep the input dtype.
    ``backend``   ``"auto"`` only: the kernel follows the device.
    """
    schedule: str = "staged"
    update: str = "rank1"
    panel_k: int = 32
    backend: str = "auto"
    shrink: float = 0.75
    min_size: int = 64
    lookahead: bool = False
    fused: bool = False
    precision: Optional[str] = None

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; one of {SCHEDULES}")
        if self.update not in UPDATES:
            raise ValueError(
                f"unknown update {self.update!r}; one of {UPDATES}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; one of {BACKENDS} (the "
                "kernel follows the tensor's device)")
        if int(self.panel_k) < 1:
            raise ValueError(f"panel_k must be >= 1, got {self.panel_k}")
        if not (0.0 < float(self.shrink) < 1.0):
            raise ValueError(f"shrink must be in (0, 1), got {self.shrink}")
        if int(self.min_size) < 2:
            raise ValueError(f"min_size must be >= 2, got {self.min_size}")
        if self.lookahead and self.schedule != "mesh":
            raise ValueError(
                "lookahead pipelines the mesh schedule's broadcast; it "
                f"requires schedule='mesh', got {self.schedule!r}")
        if self.fused and self.schedule == "mesh":
            raise ValueError(
                "fused one-pass steps are a serial/staged optimization; "
                "the mesh schedule pipelines via lookahead instead")
        if self.precision not in (None, "bf16"):
            raise ValueError(
                f"unknown precision {self.precision!r}; one of "
                "(None, 'bf16')")


# --------------------------------------------------------------------------
# shared sign helpers (guarded_pivot lives with the plain kernels)
# --------------------------------------------------------------------------

def combine_slogdet(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine (sign, logabsdet) contributions multiplicatively."""
    sign = functools.reduce(lambda a, b: a * b, [p[0] for p in parts])
    logdet = functools.reduce(lambda a, b: a + b, [p[1] for p in parts])
    return sign, logdet


def _own(a: torch.Tensor) -> torch.Tensor:
    """The engine's private contiguous copy of a square input."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    return a.clone(memory_format=torch.contiguous_format)


def _unit(ref: torch.Tensor):
    """(sign, logdet) = (1, 0) in ``ref``'s dtype and device."""
    return (torch.ones((), dtype=ref.dtype, device=ref.device),
            torch.zeros((), dtype=ref.dtype, device=ref.device))


def _close(buf: torch.Tensor, sign, logdet):
    """Fold the final 1x1 pivot ``buf[n-1, 0]`` into (sign, logdet)."""
    p = buf[-1, 0]
    return sign * torch.sign(p), logdet + torch.log(torch.abs(p))


# --------------------------------------------------------------------------
# the condensation step (rank-1)
# --------------------------------------------------------------------------

def _condense_step(buf: torch.Tensor, t: int, sign, logdet, *,
                   fused: bool, precision: Optional[str]):
    """One condensation step on the full buffer; returns (buf, sign, logdet).

    Live region at step ``t``: rows [t, N), cols [0, N - t).  ``buf`` is
    the engine's own: the unfused swap writes it in place before K1.
    """
    n = buf.shape[0]
    m = n - t
    last = m - 1
    if fused:
        buf, l, p = ops.fused_condense_step(buf, t, precision=precision)
    else:
        l, p, pc, pr, col_l, col_last = ops.pivot_operands(buf, t)
        buf.index_copy_(1, l, col_last[:, None])
        buf[:, last] = col_l
        buf = ops.rank1_update(buf, pc, pr, precision=precision)
    # sign: pivot sign, column swap, and the Laplace expansion of the
    # pivot (active row 0, active column m-1) => (-1)^(m-1)
    swap_sign = torch.where(l[0] == last, 1.0, -1.0).to(buf.dtype)
    parity = 1.0 if (m - 1) % 2 == 0 else -1.0
    sign = sign * torch.sign(p) * swap_sign * parity
    logdet = logdet + torch.log(torch.abs(p))
    return buf, sign, logdet


def condense_steps(buf: torch.Tensor, n_steps: int, *, t0: int = 0,
                   fused: bool = False, precision: Optional[str] = None):
    """Run ``n_steps`` condensation steps from step ``t0`` on the engine's
    own buffer.  Returns (buf, sign, logdet), the contribution of these
    steps (combine with `combine_slogdet`)."""
    sign, logdet = _unit(buf)
    for t in range(t0, t0 + n_steps):
        buf, sign, logdet = _condense_step(buf, t, sign, logdet, fused=fused,
                                           precision=precision)
    return buf, sign, logdet


def condense_full(a: torch.Tensor, *, fused: bool = False,
                  precision: Optional[str] = None):
    """Full serial rank-1 condensation -> (sign, logabsdet)."""
    buf = _own(a)
    n = buf.shape[0]
    if n == 0:
        return _unit(buf)
    buf, sign, logdet = condense_steps(buf, n - 1, fused=fused,
                                       precision=precision)
    return _close(buf, sign, logdet)


# --------------------------------------------------------------------------
# the panel (rank-K) primitives
# --------------------------------------------------------------------------

def panel_factor(panel: torch.Tensor, m0: int, *, r_pos: int = 0):
    """Factorize a K-row panel -> ``(R, ls, sign, logdet)`` (K4 on the card).

    ``panel`` (K, N) has live columns ``[0, m0)``; ``r_pos`` counts the
    live rows above it (sign parity only).  ``ls[k]`` is the pivot column
    chosen at step k in that step's coordinates.
    """
    return ops.panel_factor(panel, m0, r_pos)


def swap_positions(x: torch.Tensor, dim: int, l: torch.Tensor,
                    last: int) -> None:
    """In place: swap index ``l`` ((1,) tensor) with ``last`` along ``dim``."""
    at_l = x.index_select(dim, l)
    at_last = x.narrow(dim, last, 1).clone()
    x.index_copy_(dim, l, at_last)
    x.narrow(dim, last, 1).copy_(at_l)


def apply_panel(block: torch.Tensor, R: torch.Tensor, ls: torch.Tensor,
                m0: int, row_mask: torch.Tensor, *, fused: bool = False,
                precision: Optional[str] = None) -> torch.Tensor:
    """Apply a factorized panel to the trailing block -> ``block - C @ R``.

    ``block`` (Lb, N) is the engine's own buffer; its K column swaps are
    replayed in place.  ``fused=True`` composes the K swaps on an index
    vector and applies them as ONE gather restricted to the 2K columns
    the swaps can move (every other column is a fixed point), so the
    gather touches O(K * Lb) elements, not the whole block; the result is
    the same data movement, bit for bit.  The trailing GEMM is K2.
    """
    n = block.shape[1]
    k = R.shape[0]
    if fused:
        idx = torch.arange(n, device=block.device)
        for j in range(k):
            swap_positions(idx, 0, ls[j:j + 1], m0 - 1 - j)
        moved = torch.cat([ls, torch.arange(m0 - k, m0, device=block.device)])
        block.index_copy_(1, moved,
                          block.index_select(1, idx.index_select(0, moved)))
    else:
        for j in range(k):
            swap_positions(block, 1, ls[j:j + 1], m0 - 1 - j)

    # pivot-column block, reversed so column j corresponds to pivot j
    pc_cols = block[:, m0 - k:m0].flip(1)                 # (Lb, K)
    # T[j', j] = R[j', pos(pivot j)] -- unit upper-triangular
    tri = R[:, m0 - k:m0].flip(1)                         # (K, K)
    # C @ T = Pc
    c = torch.linalg.solve_triangular(tri, pc_cols, upper=True, left=False,
                                      unitriangular=True)
    c = c * row_mask[:, None]
    return ops.panel_update(block, c.contiguous(), R, precision=precision)


def panel_rounds_serial(buf: torch.Tensor, n_panels: int, k: int, *,
                        q0: int = 0, fused: bool = False,
                        precision: Optional[str] = None):
    """Run ``n_panels`` serial K-panels from panel ``q0`` on the engine's
    own buffer.  Returns (buf, sign, logdet) contributions."""
    n = buf.shape[0]
    rows = torch.arange(n, device=buf.device)
    sign, logdet = _unit(buf)
    for q in range(q0, q0 + n_panels):
        t0 = q * k
        m0 = n - t0
        R, ls, psign, plogdet = panel_factor(buf[t0:t0 + k], m0)
        row_mask = (rows >= t0 + k).to(buf.dtype)
        buf = apply_panel(buf, R, ls, m0, row_mask, fused=fused,
                          precision=precision)
        # park the factorized rows so the dead region stays finite
        buf[t0:t0 + k] = R
        sign, logdet = sign * psign, logdet + plogdet
    return buf, sign, logdet


def blocked_full(a: torch.Tensor, *, k: int = 32, fused: bool = False,
                 precision: Optional[str] = None):
    """Serial blocked condensation: K-row panels, then rank-1 steps."""
    n = a.shape[0]
    if n <= k:
        return condense_full(a, fused=fused, precision=precision)
    n_panels = (n - 1) // k
    buf, sign, logdet = panel_rounds_serial(_own(a), n_panels, k,
                                            fused=fused, precision=precision)
    t0 = n_panels * k
    buf, rsign, rlogdet = condense_steps(buf, n - 1 - t0, t0=t0, fused=fused,
                                         precision=precision)
    return _close(buf, sign * rsign, logdet + rlogdet)


# --------------------------------------------------------------------------
# staged schedule (geometric stages over shrinking buffers)
# --------------------------------------------------------------------------

def stage_schedule(n: int, shrink: float, min_size: int):
    """Static (size, steps) schedule: run `steps` at size `size`."""
    sched = []
    size = n
    while size > min_size:
        nxt = max(min_size, int(math.ceil(size * shrink)))
        steps = size - nxt
        if steps <= 0:
            break
        sched.append((size, steps))
        size = nxt
    sched.append((size, size - 1))  # finish to 1x1
    return sched


def _live(buf: torch.Tensor, steps: int) -> torch.Tensor:
    n = buf.shape[0]
    return buf[steps:, :n - steps].contiguous()


def _staged_stage_rank1(buf, steps: int, fused: bool,
                        precision: Optional[str]):
    b, s, ld = condense_steps(buf, steps, fused=fused, precision=precision)
    return _live(b, steps), s, ld


def _staged_stage_panel(buf, steps: int, k: int, fused: bool,
                        precision: Optional[str]):
    """One stage eliminating ``steps`` rows: K-panels, then remainder."""
    n_panels = steps // k
    b, s, ld = panel_rounds_serial(buf, n_panels, k, fused=fused,
                                   precision=precision)
    rem = steps - n_panels * k
    if rem > 0:
        b, rs, rld = condense_steps(b, rem, t0=n_panels * k, fused=fused,
                                    precision=precision)
        s, ld = s * rs, ld + rld
    return _live(b, steps), s, ld


def staged_full(a: torch.Tensor, *, shrink: float = 0.75, min_size: int = 64,
                update: str = "rank1", k: int = 32, fused: bool = False,
                precision: Optional[str] = None):
    """Geometric shape-staged condensation -> (sign, logabsdet).

    Runs in stages of fixed size and slices the live block out between
    stages, so later steps stream a smaller buffer.  ``update="panel"``
    runs each stage as K-panels plus rank-1 remainder steps.
    """
    n = a.shape[0]
    kw = dict(fused=fused, precision=precision)
    if n <= min_size:
        if update == "panel" and n > k:
            return blocked_full(a, k=k, **kw)
        return condense_full(a, **kw)
    parts = []
    buf = _own(a)
    for size, steps in stage_schedule(n, shrink, min_size):
        if buf.shape[0] != size:  # defensive; schedule and buffer must agree
            raise AssertionError((tuple(buf.shape), size))
        if size - steps <= 1:
            if update == "panel" and size > k:
                parts.append(blocked_full(buf, k=k, **kw))
            else:
                parts.append(condense_full(buf, **kw))
            buf = None
            break
        if update == "panel" and steps >= k:
            buf, s, ld = _staged_stage_panel(buf, steps, k, fused, precision)
        else:
            buf, s, ld = _staged_stage_rank1(buf, steps, fused, precision)
        parts.append((s, ld))
    if buf is not None:
        if update == "panel" and buf.shape[0] > k:
            parts.append(blocked_full(buf, k=k, **kw))
        else:
            parts.append(condense_full(buf, **kw))
    return combine_slogdet(parts)


# --------------------------------------------------------------------------
# engine entry point
# --------------------------------------------------------------------------

def build_serial(cfg: EngineConfig) -> Callable:
    """``a -> (sign, logabsdet)`` for the serial / staged schedules."""
    if cfg.schedule == "mesh" or cfg.lookahead:
        raise NotImplementedError(_MESH_TODO)
    kw = dict(fused=cfg.fused, precision=cfg.precision)
    if cfg.schedule == "serial":
        if cfg.update == "rank1":
            return lambda a: condense_full(a, **kw)
        return lambda a: blocked_full(a, k=cfg.panel_k, **kw)
    return lambda a: staged_full(
        a, shrink=cfg.shrink, min_size=cfg.min_size, update=cfg.update,
        k=cfg.panel_k, **kw)
