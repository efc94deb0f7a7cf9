"""The condensation engine in PyTorch: serial, staged and mesh schedules.

Counterpart of `repro.core.engine`: one implementation of the paper's
step -- pivot-column argmax (§2.2), row normalization (§2.3), column swap
(§2.4) -- over two axes:

  schedule   "serial"  one buffer, one rank per step
             "staged"  geometric stages over shrinking buffers
             "mesh"    round-robin block rows over a 1-D mesh of ranks
                       (`core.mesh`; the paper's parallel schedule)
  update     "rank1"   the outer-product subtract (kernel K1, or K3 fused)
             "panel"   K-row panels: factorize K rows (K4), then ONE
                       trailing GEMM (K2)

plus ``fused=True`` (serial/staged: one-pass steps, one composed-
permutation gather per panel), ``lookahead=True`` (mesh: the next
step's or panel's broadcast overlaps the current bulk update) and
``precision="bf16"`` (bf16 multiply operands, full-precision buffer and
accumulators).

The JAX package's legacy route strings (``mc``, ``mc_staged``,
``mc_blocked``, ``pmc``, ``pmc_blocked``) name fixed engine tuples
(`LEGACY_ROUTES`); the plan resolves them with a `DeprecationWarning`.

The mesh schedule runs in every rank's process (`torch.distributed` has
no single controller): each rank calls the same function on the same
full matrix, keeps its own row block and gets the same result.

Each step is a Python loop iteration over device work: no ``.item()``,
``float()`` or ``bool()`` of a device tensor inside the loops, so the
host only waits when the caller reads the result.  Every kernel-shaped
operation goes through `repro_torch.kernels.ops`, which launches the CUDA
kernel for a CUDA tensor and the plain version for a CPU tensor.  Unlike
the JAX package, which runs its unfused native-precision rank-1 stages
inline in jnp even with a kernel backend, every rank-1 update here goes
through K1 (or K3): the arithmetic is the same, and no plain version runs
on the card's main path.

Observability: each step runs inside the JAX package's stage names
(`repro_torch.obs.stage`): ``engine.pivot``, ``engine.swap``,
``engine.update`` or ``engine.fused_step`` per rank-1 step,
``engine.panel_factor``, ``engine.panel_swap_gather`` (fused) and
``engine.panel_apply`` per panel, and on the mesh ``engine.broadcast``,
``engine.lookahead_factor`` and ``engine.mesh_tail``.  With obs off a
stage is one shared no-op object.

Buffers: every public entry point copies its input once and never modifies
the caller's tensor; later buffers are the engine's own and are updated
in place (the column swaps) or replaced by kernel outputs.

Stacks: the serial and staged schedules also take a (B, n, n) stack and
return (B,) signs and log-determinants.  One step runs all B matrices at
once -- each kernel launches once for the stack (K1-K4's batch grids),
and the bookkeeping is the same few PyTorch ops on a leading batch axis,
never a Python loop over the matrices -- which is what `vmap` does to the
JAX package's serial core.  Each matrix pivots on its own, and its
arithmetic is the single matrix's (the triangular solve of the panel
route may round otherwise when batched).  The mesh schedule takes one
matrix.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import mesh as _mesh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (guarded_pivot, nan_sign, swap_positions,
                                     swap_positions_batched)

__all__ = [
    "EngineConfig", "SCHEDULES", "UPDATES", "BACKENDS", "build_serial",
    "build_mesh", "engine_slogdet", "condense_steps", "condense_full",
    "panel_factor", "apply_panel", "panel_rounds_serial",
    "blocked_full", "staged_full", "stage_schedule", "mc_local_phase",
    "mesh_tail", "combine_slogdet", "guarded_pivot", "nan_sign",
    "cyclic_perm", "perm_parity", "LEGACY_ROUTES",
]

SCHEDULES = ("serial", "staged", "mesh")
UPDATES = ("rank1", "panel")
# the kernel follows the tensor's device (kernels/ops.py), so the only
# backend is "auto"
BACKENDS = ("auto",)

@dataclass(frozen=True)
class EngineConfig:
    """One point in the schedule x update design space.

    ``panel_k``   panel width of the rank-K update (ignored for rank1).
    ``shrink``    geometric stage ratio of the staged schedule.
    ``min_size``  size below which the staged schedule stops staging.
    ``lookahead`` mesh-only: the next pivot row / panel is factored from
                  an early-applied copy and its broadcast issued before
                  the bulk update of the current one; bit-identical.
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


# legacy route string -> (schedule, update): the JAX package's deprecated
# aliases, each a fixed engine tuple with the default staging knobs
LEGACY_ROUTES = {
    "mc": ("serial", "rank1"),
    "mc_staged": ("staged", "rank1"),
    "mc_blocked": ("serial", "panel"),
    "pmc": ("mesh", "rank1"),
    "pmc_blocked": ("mesh", "panel"),
}


# --------------------------------------------------------------------------
# shared sign helpers (guarded_pivot and nan_sign live with the plain
# kernels)
# --------------------------------------------------------------------------

def combine_slogdet(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine (sign, logabsdet) contributions multiplicatively."""
    sign = functools.reduce(lambda a, b: a * b, [p[0] for p in parts])
    logdet = functools.reduce(lambda a, b: a + b, [p[1] for p in parts])
    return sign, logdet


def cyclic_perm(n: int, p: int) -> np.ndarray:
    """Permutation mapping block layout to cyclic: out[d*L + i] = i*p + d
    (host numpy; the Gaussian-elimination baselines' row layout)."""
    return np.arange(n).reshape(n // p, p).T.reshape(-1)


def perm_parity(perm: np.ndarray) -> float:
    """Parity (+1/-1) of a permutation via cycle decomposition (O(n),
    on the host)."""
    seen = np.zeros(len(perm), dtype=bool)
    parity = 1.0
    for start in range(len(perm)):
        if seen[start]:
            continue
        clen = 0
        j = start
        while not seen[j]:
            seen[j] = True
            j = int(perm[j])
            clen += 1
        if clen % 2 == 0:
            parity = -parity
    return parity


def _own(a: torch.Tensor) -> torch.Tensor:
    """The engine's private contiguous copy of a square input or a
    (B, n, n) stack."""
    if a.dim() not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected square matrix (n, n) or stack (B, n, n), "
                         f"got {tuple(a.shape)}")
    return a.clone(memory_format=torch.contiguous_format)


def _unit(ref: torch.Tensor):
    """(sign, logdet) = (1, 0) in ``ref``'s dtype and device, one per
    matrix of a stack (0-d for one matrix)."""
    return (torch.ones(ref.shape[:-2], dtype=ref.dtype, device=ref.device),
            torch.zeros(ref.shape[:-2], dtype=ref.dtype, device=ref.device))


def _close(buf: torch.Tensor, sign, logdet):
    """Fold the final 1x1 pivot ``buf[..., n-1, 0]`` into (sign, logdet)."""
    p = buf[..., -1, 0]
    return sign * nan_sign(p), logdet + torch.log(torch.abs(p))


# --------------------------------------------------------------------------
# the condensation step (rank-1)
# --------------------------------------------------------------------------

def _condense_step(buf: torch.Tensor, t: int, sign, logdet, *,
                   fused: bool, precision: Optional[str]):
    """One condensation step on the full buffer; returns (buf, sign, logdet).

    Live region at step ``t``: rows [t, N), cols [0, N - t).  ``buf`` is
    the engine's own: the unfused swap writes it in place before K1.  On
    a (B, N, N) stack every matrix takes its own pivot (``l``, ``p``
    (B,)), in one launch.
    """
    stack = buf.dim() == 3
    n = buf.shape[-1]
    m = n - t
    last = m - 1
    if fused:
        with obs.stage("engine.fused_step"):
            buf, l, p = ops.fused_condense_step(buf, t, precision=precision)
    else:
        with obs.stage("engine.pivot"):
            l, p, pc, pr, col_l, col_last = ops.pivot_operands(buf, t)
        with obs.stage("engine.swap"):
            if stack:
                buf.scatter_(2, l[:, None, None].expand(buf.shape[0], n, 1),
                             col_last[:, :, None])
            else:
                buf.index_copy_(1, l, col_last[:, None])
            buf[..., last] = col_l
        with obs.stage("engine.update"):
            buf = ops.rank1_update(buf, pc, pr, precision=precision)
    # sign: pivot sign, column swap, and the Laplace expansion of the
    # pivot (active row 0, active column m-1) => (-1)^(m-1)
    swap_sign = torch.where((l if stack else l[0]) == last, 1.0,
                            -1.0).to(buf.dtype)
    parity = 1.0 if (m - 1) % 2 == 0 else -1.0
    sign = sign * nan_sign(p) * swap_sign * parity
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
    n = buf.shape[-1]
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
    with obs.stage("engine.panel_factor"):
        return ops.panel_factor(panel, m0, r_pos)


def _panel_operand(block: torch.Tensor, R: torch.Tensor, ls: torch.Tensor,
                  m0: int, *, fused: bool = False) -> torch.Tensor:
    """Replay a factorized panel's K column swaps on ``block`` (Lb, N), in
    place, and return its multipliers ``C`` (Lb, K): ``C @ T = Pc``.  A
    stack (B, Lb, N) replays each matrix's own swaps (``ls`` (B, K)).

    ``fused=True`` composes the K swaps on an index vector and applies
    them as ONE gather restricted to the 2K columns the swaps can move
    (every other column is a fixed point), so the gather touches O(K *
    Lb) elements, not the whole block; the result is the same data
    movement, bit for bit.
    """
    if block.dim() == 3:
        _replay_swaps_stack(block, ls, m0, fused)
    elif fused:
        with obs.stage("engine.panel_swap_gather"):
            n = block.shape[1]
            k = R.shape[0]
            idx = torch.arange(n, device=block.device)
            for j in range(k):
                swap_positions(idx, 0, ls[j:j + 1], m0 - 1 - j)
            moved = torch.cat([ls, torch.arange(m0 - k, m0,
                                                device=block.device)])
            block.index_copy_(1, moved,
                              block.index_select(1,
                                                 idx.index_select(0, moved)))
    else:
        for j in range(R.shape[0]):
            swap_positions(block, 1, ls[j:j + 1], m0 - 1 - j)

    k = R.shape[-2]
    # pivot-column block, reversed so column j corresponds to pivot j
    pc_cols = block[..., m0 - k:m0].flip(-1)              # (Lb, K)
    # T[j', j] = R[j', pos(pivot j)] -- unit upper-triangular
    tri = R[..., m0 - k:m0].flip(-1)                      # (K, K)
    # C @ T = Pc
    return torch.linalg.solve_triangular(tri, pc_cols, upper=True,
                                         left=False, unitriangular=True)


def _replay_swaps_stack(block: torch.Tensor, ls: torch.Tensor, m0: int,
                        fused: bool) -> None:
    """`_panel_operand`'s swaps on a (B, Lb, N) stack, in place: matrix b
    takes its own ``ls[b]``."""
    b, rows, n = block.shape
    k = ls.shape[1]
    if not fused:
        for j in range(k):
            swap_positions_batched(block, 2, ls[:, j], m0 - 1 - j)
        return
    with obs.stage("engine.panel_swap_gather"):
        idx = torch.arange(n, device=block.device).expand(b, n).clone()
        for j in range(k):
            swap_positions_batched(idx, 1, ls[:, j], m0 - 1 - j)
        tail = torch.arange(m0 - k, m0, device=block.device).expand(b, k)
        moved = torch.cat([ls, tail], dim=1)                   # (B, 2K)
        src = idx.gather(1, moved)[:, None, :].expand(b, rows, 2 * k)
        block.scatter_(2, moved[:, None, :].expand(b, rows, 2 * k),
                       block.gather(2, src))


def apply_panel(block: torch.Tensor, R: torch.Tensor, ls: torch.Tensor,
                m0: int, row_mask: torch.Tensor, *, fused: bool = False,
                precision: Optional[str] = None) -> torch.Tensor:
    """Apply a factorized panel to the trailing block -> ``block - C @ R``.

    ``block`` (Lb, N) is the engine's own buffer; its K column swaps are
    replayed in place (`_panel_operand`).  Rows where ``row_mask`` is 0
    are left alone.  The trailing GEMM is K2.
    """
    c = _panel_operand(block, R, ls, m0, fused=fused)
    with obs.stage("engine.panel_apply"):
        return ops.panel_update(block, (c * row_mask[:, None]).contiguous(),
                                R, precision=precision)


def panel_rounds_serial(buf: torch.Tensor, n_panels: int, k: int, *,
                        q0: int = 0, fused: bool = False,
                        precision: Optional[str] = None):
    """Run ``n_panels`` serial K-panels from panel ``q0`` on the engine's
    own buffer.  Returns (buf, sign, logdet) contributions."""
    n = buf.shape[-1]
    rows = torch.arange(n, device=buf.device)
    sign, logdet = _unit(buf)
    for q in range(q0, q0 + n_panels):
        t0 = q * k
        m0 = n - t0
        R, ls, psign, plogdet = panel_factor(buf[..., t0:t0 + k, :], m0)
        row_mask = (rows >= t0 + k).to(buf.dtype)
        buf = apply_panel(buf, R, ls, m0, row_mask, fused=fused,
                          precision=precision)
        # park the factorized rows so the dead region stays finite
        buf[..., t0:t0 + k, :] = R
        sign, logdet = sign * psign, logdet + plogdet
    return buf, sign, logdet


def blocked_full(a: torch.Tensor, *, k: int = 32, fused: bool = False,
                 precision: Optional[str] = None):
    """Serial blocked condensation: K-row panels, then rank-1 steps."""
    n = a.shape[-1]
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
    n = buf.shape[-1]
    return buf[..., steps:, :n - steps].contiguous()


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
    n = a.shape[-1]
    kw = dict(fused=fused, precision=precision)
    if n <= min_size:
        if update == "panel" and n > k:
            return blocked_full(a, k=k, **kw)
        return condense_full(a, **kw)
    parts = []
    buf = _own(a)
    for size, steps in stage_schedule(n, shrink, min_size):
        if buf.shape[-1] != size:  # defensive; schedule and buffer must agree
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
        if update == "panel" and buf.shape[-1] > k:
            parts.append(blocked_full(buf, k=k, **kw))
        else:
            parts.append(condense_full(buf, **kw))
    return combine_slogdet(parts)


# --------------------------------------------------------------------------
# mesh schedule (round-robin block rows, one process per rank)
# --------------------------------------------------------------------------
#
# Rank p owns rows [p L, (p + 1) L).  Global step t = i P + p eliminates
# rank p's local row i: the owner picks the pivot column in its own row
# and normalizes it (no communication), ONE broadcast carries the
# normalized row and the column index to every rank, every rank swaps the
# columns l <-> last of its block (the redundant §2.4 swaps) and applies
# the rank-1 update to its live rows.  After (L - 1) P steps each rank
# holds one live row; the P x P tail is reduced on every rank
# (`mesh_tail`).  Owner tests and parities are host arithmetic on ints;
# the pivot index stays on the device (a host int would wait on every
# step).

def _pack(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One broadcast buffer: ``rows`` flattened, then the column indices
    ``idx`` as floats, exact below 2**24 columns in f32."""
    return torch.cat([rows.reshape(-1), idx.to(rows.dtype).reshape(-1)])


def _unpack(buf: torch.Tensor, shape):
    n = math.prod(shape)
    return buf[:n].view(shape), buf[n:].to(torch.int64)


def _select_pivot(row: torch.Tensor, m: int):
    """Owner-local pivot choice in ``row[:m]`` and the §2.3/§2.4 row
    normalization -> ``(pr, l, p)``: the row with columns l and m - 1
    swapped, divided by the pivot (``pr[m - 1] == 1``; all zero for a
    zero pivot), the pivot column as a (1,) int64 tensor, the pivot."""
    last = m - 1
    l = row[:m].abs().argmax().view(1)
    p = row.index_select(0, l)[0]
    r = row.clone()
    r.index_copy_(0, l, row[last:last + 1])
    r[last] = p
    return torch.where(p == 0, torch.zeros_like(r), r / guarded_pivot(p)), l, p


def _step_sign(p, l, m: int, r_pos: int, sign, logdet):
    """Fold one pivot into the owner's partial (sign, logdet): its sign,
    the swap's, and the Laplace parity (-1)^(r_pos + m - 1), where
    ``r_pos`` counts the live rows above the pivot row."""
    swap_sign = torch.where(l[0] == m - 1, 1.0, -1.0).to(sign.dtype)
    parity = 1.0 if (r_pos + m - 1) % 2 == 0 else -1.0
    return (sign * nan_sign(p) * swap_sign * parity,
            logdet + torch.log(torch.abs(p)))


def _mesh_update(local: torch.Tensor, pr_b, l_b, last: int, dead: int,
                 precision: Optional[str]) -> torch.Tensor:
    """Every rank: swap columns ``l_b`` <-> ``last`` of its block in place,
    then the rank-1 update (K1) of its rows from ``dead`` on."""
    with obs.stage("engine.swap"):
        swap_positions(local, 1, l_b, last)
    with obs.stage("engine.update"):
        pc = local[:, last].clone()
        pc[:dead] = 0
        return ops.rank1_update(local, pc, pr_b, precision=precision)


def _empty(local: torch.Tensor, size: int) -> torch.Tensor:
    return torch.empty(size, dtype=local.dtype, device=local.device)


def mc_local_phase(local: torch.Tensor, mesh, *, t0: int = 0,
                   n_steps: Optional[int] = None,
                   precision: Optional[str] = None):
    """The distributed rank-1 phase on this rank's block (L, N): global
    steps ``[t0, t0 + n_steps)`` (default: all ``(L - 1) P``).  Returns
    ``(local, sign, logdet)``, the partials of the steps this rank owned.
    """
    L, N = local.shape
    P, me = mesh.size, mesh.rank
    if n_steps is None:
        n_steps = (L - 1) * P - t0
    sign, logdet = _unit(local)
    for t in range(t0, t0 + n_steps):
        i, p = divmod(t, P)
        m = N - t
        with obs.stage("engine.pivot"):
            if me == p:
                pr, l, pv = _select_pivot(local[i], m)
                buf = _pack(pr, l)
                sign, logdet = _step_sign(pv, l, m, p * (L - 1 - i), sign,
                                          logdet)
            else:
                buf = _empty(local, N + 1)
        with obs.stage("engine.broadcast"):
            _mesh.broadcast(mesh, buf, p)
        pr_b, l_b = _unpack(buf, (N,))
        local = _mesh_update(local, pr_b, l_b, m - 1, i + (me <= p),
                             precision)
    return local, sign, logdet


def mesh_tail(local: torch.Tensor, sign, logdet, mesh):
    """The P x P tail (paper pseudocode steps 5-8), the same on every rank.

    Each rank's last row is its one live row, live in columns [0, P).
    ONE all_reduce of a zero-filled (P, P + 2) buffer, row p holding rank
    p's live prefix, partial sign and partial logdet, gathers the tail
    and the partials exactly (each sum adds zeros to one value); every
    rank then condenses the tail (K1 on the card) and combines.
    """
    L, N = local.shape
    P = mesh.size
    with obs.stage("engine.mesh_tail"):
        buf = torch.zeros((P, P + 2), dtype=local.dtype, device=local.device)
        buf[mesh.rank, :P] = local[L - 1, :P]
        buf[mesh.rank, P] = sign
        buf[mesh.rank, P + 1] = logdet
        _mesh.all_sum(mesh, buf)
        tsign, tlogdet = condense_full(buf[:, :P])
        return torch.prod(buf[:, P]) * tsign, buf[:, P + 1].sum() + tlogdet


def _mesh_rank1(local, mesh, precision):
    local, sign, logdet = mc_local_phase(local, mesh, precision=precision)
    return mesh_tail(local, sign, logdet, mesh)


def _mesh_rank1_lookahead(local, mesh, precision):
    """Rank-1 mesh schedule with single-row lookahead.

    Each iteration waits for the broadcast of step t, early-applies it to
    the NEXT pivot row on that row's owner (a 1 x N copy through the same
    K1 as the bulk update, so every element sees the same rounded
    operations), selects and normalizes that row's pivot, issues its
    broadcast asynchronously, and only then runs the bulk update of step
    t: the collective of step t + 1 overlaps the update of step t.
    Bit-identical to `_mesh_rank1`.
    """
    L, N = local.shape
    P, me = mesh.size, mesh.rank
    n_steps = (L - 1) * P
    sign, logdet = _unit(local)
    if n_steps:
        if me == 0:
            pr, l, pv = _select_pivot(local[0], N)
            buf = _pack(pr, l)
            sign, logdet = _step_sign(pv, l, N, 0, sign, logdet)
        else:
            buf = _empty(local, N + 1)
        with obs.stage("engine.broadcast"):
            work = _mesh.broadcast(mesh, buf, 0, async_op=True)
    for t in range(n_steps):
        i, p = divmod(t, P)
        m = N - t
        last = m - 1
        with obs.stage("engine.broadcast"):
            work.wait()
        pr_b, l_b = _unpack(buf, (N,))
        if t + 1 < n_steps:
            i1, p1 = divmod(t + 1, P)
            with obs.stage("engine.lookahead_factor"):
                if me == p1:
                    row = local[i1:i1 + 1].clone()
                    swap_positions(row, 1, l_b, last)
                    row = ops.rank1_update(row, row[:, last].clone(), pr_b,
                                           precision=precision)
                    pr, l, pv = _select_pivot(row[0], m - 1)
                    nbuf = _pack(pr, l)
                    sign, logdet = _step_sign(pv, l, m - 1,
                                              p1 * (L - 1 - i1), sign, logdet)
                else:
                    nbuf = _empty(local, N + 1)
            with obs.stage("engine.broadcast"):
                nwork = _mesh.broadcast(mesh, nbuf, p1, async_op=True)
        local = _mesh_update(local, pr_b, l_b, last, i + (me <= p), precision)
        if t + 1 < n_steps:
            buf, work = nbuf, nwork
    return mesh_tail(local, sign, logdet, mesh)


def _dead_mask(local, me: int, r: int, p: int, k: int) -> torch.Tensor:
    """1 for the rows of this rank that panel (r, p) updates."""
    dead = (r + 1) * k if me <= p else r * k
    return (torch.arange(local.shape[0], device=local.device)
            >= dead).to(local.dtype)


def _mesh_panel(local, mesh, k: int, precision, lookahead: bool):
    """Round-robin K-panel mesh schedule.

    The owner of global panel g = r P + p factorizes K of its own rows
    (K4; MC's local pivoting, no global pivot search), ONE broadcast
    carries ``(R, ls)``, and every rank applies the rank-K update (K2) to
    its live rows.  Remainder rows take the rank-1 schedule, then the
    P x P tail.

    ``lookahead``: each iteration replays panel g's swaps and solves its
    multipliers for the whole block, then the owner of panel g + 1
    early-applies panel g to its K next rows (K2 on the K-row slice: K2
    sums every element in the same order whatever the row count, so the
    rows equal the bulk update's bit for bit), factors them and issues
    their broadcast asynchronously before the bulk K2 of panel g.
    """
    L, N = local.shape
    P, me = mesh.size, mesh.rank
    n_rounds = (L - 1) // k
    n_panels = n_rounds * P
    sign, logdet = _unit(local)
    size = k * N + k

    def factor(block, g):
        nonlocal sign, logdet
        r, p = divmod(g, P)
        R, ls, ps, pld = panel_factor(block, N - g * k,
                                      r_pos=p * (L - (r + 1) * k))
        sign, logdet = sign * ps, logdet + pld
        return _pack(R, ls)

    if lookahead and n_panels:
        buf = factor(local[:k], 0) if me == 0 else _empty(local, size)
        with obs.stage("engine.broadcast"):
            work = _mesh.broadcast(mesh, buf, 0, async_op=True)
    for g in range(n_panels):
        r, p = divmod(g, P)
        m0 = N - g * k
        if lookahead:
            with obs.stage("engine.broadcast"):
                work.wait()
        else:
            buf = factor(local[r * k:(r + 1) * k], g) if me == p \
                else _empty(local, size)
            with obs.stage("engine.broadcast"):
                _mesh.broadcast(mesh, buf, p)
        R_b, ls_b = _unpack(buf, (k, N))
        c = _panel_operand(local, R_b, ls_b, m0)
        if lookahead and g + 1 < n_panels:
            r1, p1 = divmod(g + 1, P)
            with obs.stage("engine.lookahead_factor"):
                if me == p1:
                    rows = slice(r1 * k, (r1 + 1) * k)
                    nxt = ops.panel_update(local[rows], c[rows].contiguous(),
                                           R_b, precision=precision)
                    nbuf = factor(nxt, g + 1)
                else:
                    nbuf = _empty(local, size)
            with obs.stage("engine.broadcast"):
                nwork = _mesh.broadcast(mesh, nbuf, p1, async_op=True)
        with obs.stage("engine.panel_apply"):
            mask = _dead_mask(local, me, r, p, k)
            local = ops.panel_update(local, (c * mask[:, None]).contiguous(),
                                     R_b, precision=precision)
        if lookahead and g + 1 < n_panels:
            buf, work = nbuf, nwork

    rem = (L - 1) - n_rounds * k
    if rem > 0:
        local, rsign, rlogdet = mc_local_phase(
            local, mesh, t0=n_rounds * k * P, n_steps=rem * P,
            precision=precision)
        sign, logdet = sign * rsign, logdet + rlogdet
    return mesh_tail(local, sign, logdet, mesh)


# --------------------------------------------------------------------------
# engine entry point
# --------------------------------------------------------------------------

def build_serial(cfg: EngineConfig) -> Callable:
    """``a -> (sign, logabsdet)`` for the serial / staged schedules."""
    if cfg.schedule == "mesh":
        raise ValueError("mesh schedule needs build_mesh(cfg, mesh)")
    kw = dict(fused=cfg.fused, precision=cfg.precision)
    if cfg.schedule == "serial":
        if cfg.update == "rank1":
            return lambda a: condense_full(a, **kw)
        return lambda a: blocked_full(a, k=cfg.panel_k, **kw)
    return lambda a: staged_full(
        a, shrink=cfg.shrink, min_size=cfg.min_size, update=cfg.update,
        k=cfg.panel_k, **kw)


def build_mesh(cfg: EngineConfig, mesh) -> Callable:
    """``a -> (sign, logabsdet)`` over a 1-D mesh (`core.mesh.Mesh`).

    Every rank calls the function on the same full (N, N) matrix, N
    divisible by the mesh size; each copies its row block to
    ``mesh.device`` and all return the same result.
    """
    if cfg.schedule != "mesh":
        raise ValueError(
            f"build_mesh needs schedule='mesh', got {cfg.schedule!r}")

    def run(a):
        n = a.shape[0]
        if a.dim() != 2 or a.shape[1] != n:
            raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
        if n >= 2 ** 24 and a.dtype == torch.float32:
            raise ValueError("the broadcast carries column indices as f32, "
                             f"exact below 2**24 columns; got N={n}")
        local = a[mesh.block(n)].to(mesh.device, copy=True).contiguous()
        if cfg.update == "rank1":
            kernel = _mesh_rank1_lookahead if cfg.lookahead else _mesh_rank1
            return kernel(local, mesh, cfg.precision)
        return _mesh_panel(local, mesh, cfg.panel_k, cfg.precision,
                           cfg.lookahead)

    return run


def engine_slogdet(a: torch.Tensor, cfg: EngineConfig = EngineConfig(), *,
                   mesh=None):
    """One-shot engine execution (tests / exploration); plans build once
    through `build_serial` / `build_mesh` and reuse."""
    if cfg.schedule == "mesh":
        if mesh is None:
            raise ValueError("mesh schedule requires a mesh")
        return build_mesh(cfg, mesh)(a)
    return build_serial(cfg)(a)
