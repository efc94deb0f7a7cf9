"""Gaussian elimination baselines (paper §2.5, §3), serial and on a mesh.

Counterpart of `repro.core.gaussian`.  The paper compares Matrix
Condensation against Gaussian Elimination with partial pivoting, which
must eliminate top to bottom: load balance needs a **cyclic row
distribution**, and partial pivoting a **global pivot search and a row
exchange across ranks** every step -- the two costs condensation avoids.

  * `slogdet_ge`            serial GE with partial pivoting (one matrix or
                            a (B, n, n) stack).
  * `parallel_slogdet_ge`   GE over a `core.mesh.Mesh`: cyclic rows (global
                            row g on rank g mod P), the global pivot search,
                            and the pivot row and the displaced row sent to
                            every rank.

Every rank-1 subtract is K1 (`kernels.ops.rank1_update`) on a CUDA tensor,
as everywhere in the port, where the JAX package runs plain jnp: the
baselines and condensation are compared on the same kernels.  Each step
updates only the rows below the pivot row: the JAX package's masked
full-buffer update leaves the others as they are (they are never read
again), so the results are the same.

Collectives per step on a mesh (`core.mesh.collective_counts`): one
all_sum of the P ranks' candidates (value and global row, the JAX
package's two all_gathers), then the two row broadcasts -- the pivot row
as an all_sum of masked rows (its owner is known only on the device, as
in the JAX package's psum) and row t by a broadcast from its owner t mod
P (known on the host).  Condensation sends one row a step.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mesh as _mesh
from repro_torch.core.engine import (_own, _unit, cyclic_perm, guarded_pivot,
                                     nan_sign, perm_parity)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import swap_positions, swap_positions_batched

__all__ = ["slogdet_ge", "parallel_slogdet_ge", "ge_step_fn", "cyclic_perm",
           "perm_parity"]


def slogdet_ge(a: torch.Tensor):
    """Serial Gaussian elimination with partial pivoting -> ``(sign,
    logabsdet)`` with `numpy.linalg.slogdet` semantics (NaN sign for a NaN
    pivot).

    ``live`` holds the rows not yet eliminated; step t swaps the first
    max-abs entry of column t (NaN counts as the maximum, as in
    ``jnp.argmax``) to the top and replaces the rows below by their K1
    update.  No host synchronization inside the loop.  A (B, n, n) stack
    runs every step on all B matrices, each with its own pivot row, and
    one K1 launch (its batch grid, on the rows below each pivot row in
    place, a strided view): (B,) results.
    """
    live = _own(a)
    if live.dim() == 3:
        return _slogdet_ge_stack(live)
    n = live.shape[0]
    sign, logdet = _unit(live)
    for t in range(n):
        r = live[:, t].abs().argmax().view(1)
        swap_positions(live, 0, r, 0)
        p = live[0, t]
        sign, logdet = _fold(sign, logdet, p, r[0] != 0)
        if t + 1 < n:
            rest = live[1:]
            live = ops.rank1_update(rest, rest[:, t] / guarded_pivot(p),
                                    live[0])
    return sign, logdet


def _slogdet_ge_stack(live: torch.Tensor):
    """`slogdet_ge`'s steps on the engine's own (B, n, n) stack."""
    n = live.shape[-1]
    sign, logdet = _unit(live)
    for t in range(n):
        r = live[:, :, t].abs().argmax(-1)                      # (B,)
        swap_positions_batched(live, 1, r, 0)
        p = live[:, 0, t]
        sign, logdet = _fold(sign, logdet, p, r != 0)
        if t + 1 < n:
            rest = live[:, 1:]
            live = ops.rank1_update(rest, rest[:, :, t]
                                    / guarded_pivot(p)[:, None],
                                    live[:, 0].contiguous())
    return sign, logdet


# --------------------------------------------------------------------------
# one column step on a mesh (shared with the ScaLAPACK-style LU)
# --------------------------------------------------------------------------

def _pivot_and_exchange(mesh, live: torch.Tensor, side: Optional[torch.Tensor],
                        dropped: int, c: int):
    """Steps 1-3 of a column step of GE with partial pivoting on this
    rank's live cyclic rows (global rows >= c; ``dropped`` rows of this
    rank are done): the global search for the pivot in column ``c``, the
    pivot row and row ``c`` sent to every rank, and their exchange.
    ``side`` (rows, w) travels with the rows (LU's multipliers) or is
    None.  Returns ``(pivot, swapped)``: the pivot row (with its side
    row, N + w values, the same on every rank) and whether it was not
    row c (0-d bool)."""
    P, me = mesh.size, mesh.rank
    rows, n = live.shape
    dev, dt = live.device, live.dtype
    width = n + (0 if side is None else side.shape[1])

    # 1. search: the first max-abs entry of this rank's column, then the
    #    lowest rank holding the maximum (jnp.argmax order, NaN as max)
    cand = torch.zeros((2, P), dtype=dt, device=dev)
    if rows:
        col = live[:, c].abs()
        i = col.argmax()
        cand[0, me] = col[i]
        cand[1, me] = ((i + dropped) * P + me).to(dt)
    else:
        cand[0, me] = -torch.inf
    _mesh.all_sum(mesh, cand)
    pivot_g = cand[1, cand[0].argmax()].to(torch.int64)

    # 2. the pivot row: a sum of rows that only its owner fills
    pivot = torch.zeros(width, dtype=dt, device=dev)
    if rows:
        mine = (pivot_g % P) == me
        idx = (pivot_g // P - dropped).clamp(0, rows - 1).view(1)
        own = _row(live, side, idx)
        pivot = torch.where(mine, own, pivot)
    _mesh.all_sum(mesh, pivot)
    #    and row c, from its owner
    owner_c = c % P
    if me == owner_c:
        row_c = _row(live, side, slice(0, 1))
    else:
        row_c = torch.empty(width, dtype=dt, device=dev)
    _mesh.broadcast(mesh, row_c, owner_c)

    # 3. the exchange: row c's owner takes the pivot row, the pivot row's
    #    owner takes row c
    swapped = pivot_g != c
    if me == owner_c:
        _set_row(live, side, slice(0, 1),
                 torch.where(swapped, pivot, row_c))
    if rows:
        take = swapped & mine
        _set_row(live, side, idx,
                 torch.where(take, row_c, _row(live, side, idx)))
    return pivot, swapped


def _row(live, side, at) -> torch.Tensor:
    """Row ``at`` (a (1,) index tensor or a one-row slice) of ``live``
    with its ``side`` row appended, as one vector."""
    pick = (lambda x: x.index_select(0, at)) if torch.is_tensor(at) \
        else (lambda x: x[at])
    if side is None:
        return pick(live)[0].clone()
    return torch.cat([pick(live)[0], pick(side)[0]])


def _set_row(live, side, at, value) -> None:
    n = live.shape[1]
    for x, v in ((live, value[:n]), (side, value[n:])):
        if x is None:
            continue
        if torch.is_tensor(at):
            x.index_copy_(0, at, v[None])
        else:
            x[at] = v


def _fold(sign, logdet, p, swapped):
    """Fold one pivot and its row exchange into (sign, logdet)."""
    return (sign * torch.where(swapped, -1.0, 1.0).to(sign.dtype)
            * nan_sign(p), logdet + torch.log(torch.abs(p)))


def ge_step_fn(mesh):
    """Per-step body of parallel GE on this rank's cyclic rows: global row
    g lives on rank g mod P at local index g // P.

    Returns ``step(t, (live, dropped, sign, logdet))``: ``live`` is this
    rank's rows with global index >= t (its first ``dropped`` rows are
    done).  Step t finds and exchanges the pivot, folds it into (sign,
    logdet), drops row t on its owner and applies K1 to this rank's rows
    below it."""

    def step(t, carry):
        live, dropped, sign, logdet = carry
        pivot, swapped = _pivot_and_exchange(mesh, live, None, dropped, t)
        p = pivot[t]
        sign, logdet = _fold(sign, logdet, p, swapped)
        if t % mesh.size == mesh.rank:
            live, dropped = live[1:], dropped + 1
        if live.shape[0]:
            live = ops.rank1_update(live, live[:, t] / guarded_pivot(p),
                                    pivot)
        return live, dropped, sign, logdet

    return step


def _cyclic_block(a: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's cyclic rows of ``a`` (global rows i P + rank), copied to
    ``mesh.device``."""
    n = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError(f"expected square matrix, got {tuple(a.shape)}")
    if n % mesh.size:
        raise ValueError(f"N={n} not divisible by mesh size {mesh.size}")
    if n >= 2 ** 24 and a.dtype == torch.float32:
        raise ValueError("the pivot search carries row indices as f32, "
                         f"exact below 2**24 rows; got N={n}")
    # global rows i P + rank: this rank's block of a[cyclic_perm(n, P)]
    rows = torch.arange(mesh.rank, n, mesh.size, device=a.device)
    return a.index_select(0, rows).to(mesh.device, copy=True).contiguous()


def parallel_slogdet_ge(mesh):
    """Parallel GE with partial pivoting over a 1-D mesh.

    Returns ``f(a) -> (sign, logabsdet)`` for an (N, N) matrix, N divisible
    by the mesh size, which every rank calls on the same matrix and which
    returns the same result on every rank (on ``mesh.device``).  Rows are
    distributed cyclically, which load-balances GE (paper Fig. 1).

    Deliberate difference from `repro.core.gaussian.parallel_slogdet_ge`:
    the rows keep their global indices throughout (pivot search, exchange,
    elimination order), so the result is det(A)'s and no permutation
    parity enters the sign.  The JAX package multiplies its sign by the
    parity of `cyclic_perm`, which flips it wherever that parity is -1
    (N = 38 on two devices, for one).
    """
    step = ge_step_fn(mesh)

    def run(a):
        live = _cyclic_block(a, mesh)
        n = live.shape[1]
        carry = (live, 0, *_unit(live))
        for t in range(n):
            carry = step(t, carry)
        return carry[2], carry[3]

    return run
