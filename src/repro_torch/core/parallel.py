"""Parallel Matrix Condensation (the paper's contribution): the engine's
mesh route under its historical name.

Counterpart of `repro.core.parallel`.  Schedule (paper §2.1, Fig. 2 and
the pseudocode of Fig. 6): block-row distribution (rank ``p`` owns rows
``[p L, (p + 1) L)``), global step ``t = i P + p`` eliminates rank
``p``'s local row ``i``, local pivoting and ONE broadcast per step (the
normalized pivot row and its column index), redundant §2.4 column swaps,
and the P x P tail reduced on every rank (`engine.mesh_tail`).

The sign is tracked exactly (the paper tracks only |det|): each step
contributes ``sign(pivot) * swap_sign * (-1)^(r_pos + m - 1)`` with
``r_pos = p (L - 1 - i)`` live rows above the pivot row.
"""
from __future__ import annotations

from repro_torch.core.engine import (EngineConfig, build_mesh,
                                     mc_local_phase)

__all__ = ["parallel_slogdet_mc", "mc_local_phase"]


def parallel_slogdet_mc(mesh, *, lookahead: bool = False):
    """Parallel Matrix Condensation over a 1-D mesh: the engine route
    ``(schedule="mesh", update="rank1")``.  Returns ``f(a) -> (sign,
    logabsdet)`` for an (N, N) matrix, N divisible by the mesh size, which
    every rank calls on the same matrix.  ``lookahead=True`` pipelines the
    next pivot row's broadcast past the current bulk update
    (bit-identical results)."""
    return build_mesh(EngineConfig(schedule="mesh", update="rank1",
                                   lookahead=lookahead), mesh)
