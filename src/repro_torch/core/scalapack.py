"""Library-style blocked right-looking LU baseline (the "ScaLAPACK" row of
the paper's Table 3).

Counterpart of `repro.core.scalapack`: cyclic row distribution (global
row g on rank g mod P), right-looking blocked LU with partial pivoting
and a block size ``nb``:

  * ``nb = 1``   the paper's setting (a global pivot search, a row
    exchange and a full-width update every column);
  * ``nb = 32+`` the library at strength.

Per column (`gaussian._pivot_and_exchange`): the global pivot search and
the exchange of the pivot row and row c, each row carrying its
multipliers; then the column's multipliers and K1 (`kernels.ops
.rank1_update`) on the rows below, restricted by a column mask to the
panel (the last column of a panel has nothing to update there, so it
launches nothing).  Per panel: ONE all_sum gathers the panel's rows
(A12) and multipliers (L11) -- the JAX package's one-hot psum; each rank
keeps its own panel rows as they leave the live block, final from their
exchange on -- a triangular solve for U12 on every rank (a library call,
as in the JAX package), and the trailing update ``A22 - L21 @ U12`` (K2,
K = nb).

Collectives per call: 3 per column (search, pivot row, row c) plus 1 per
panel; condensation sends one row a step.
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh as _mesh
from repro_torch.core.engine import _unit, guarded_pivot
from repro_torch.core.gaussian import (_cyclic_block, _fold,
                                       _pivot_and_exchange)
from repro_torch.kernels import ops

__all__ = ["parallel_slogdet_lu"]


def parallel_slogdet_lu(mesh, *, nb: int = 1):
    """Blocked LU log-determinant over a 1-D mesh (cyclic rows, partial
    pivoting, block size ``nb``).

    Returns ``f(a) -> (sign, logabsdet)`` for an (N, N) matrix, N divisible
    by the mesh size and by ``nb``, which every rank calls on the same
    matrix and which returns the same result on every rank.  As in
    `gaussian.parallel_slogdet_ge`, no permutation parity enters the sign
    (the JAX package's does, wrongly where it is -1).
    """
    if int(nb) < 1:
        raise ValueError(f"nb must be >= 1, got {nb}")
    P, me = mesh.size, mesh.rank

    def run(a):
        n = a.shape[0]
        if n % nb:
            raise ValueError(f"N={n} not divisible by blocksize {nb}")
        live = _cyclic_block(a, mesh)
        dev, dt = live.device, live.dtype
        cols = torch.arange(n, device=dev)
        sign, logdet = _unit(live)
        dropped = 0
        for t0 in range(0, n, nb):
            f = torch.zeros((live.shape[0], nb), dtype=dt, device=dev)
            # this rank's rows of the panel, with their multipliers
            owned = torch.zeros((nb, n + nb), dtype=dt, device=dev)
            for c in range(t0, t0 + nb):
                pivot, swapped = _pivot_and_exchange(mesh, live, f, dropped,
                                                     c)
                p = pivot[c]
                sign, logdet = _fold(sign, logdet, p, swapped)
                if c % P == me:
                    owned[c - t0, :n] = live[0]
                    owned[c - t0, n:] = f[0]
                    live, f, dropped = live[1:], f[1:], dropped + 1
                if live.shape[0]:
                    factor = live[:, c] / guarded_pivot(p)
                    f[:, c - t0] = factor
                    if c + 1 < t0 + nb:     # the panel's columns right of c
                        mask = ((cols > c) & (cols < t0 + nb)).to(dt)
                        live = ops.rank1_update(live, factor,
                                                pivot[:n] * mask)
            # the panel's rows on every rank, then the trailing update
            _mesh.all_sum(mesh, owned)
            u12 = torch.linalg.solve_triangular(
                owned[:, n:], owned[:, :n], upper=False,
                unitriangular=True).contiguous()
            if live.shape[0]:
                live = ops.panel_update(live, f, u12)
        return sign, logdet

    return run
