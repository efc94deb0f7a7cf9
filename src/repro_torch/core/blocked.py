"""Blocked (rank-K panel) condensation: the engine's panel routes under
their historical names.

Counterpart of `repro.core.blocked`.  Accumulating K pivot rows into a
panel turns K bandwidth-bound rank-1 updates into one rank-K GEMM (K2)
while keeping both of the paper's schedule freedoms (local pivot-column
choice inside the panel, block-row distribution, no global pivot
search).  On the mesh one (K N + K) broadcast carries a panel: K times
fewer collectives than rank-1 condensation for the same bytes.
"""
from __future__ import annotations

from repro_torch.core.engine import (EngineConfig, apply_panel,
                                     blocked_full as slogdet_condense_blocked,
                                     build_mesh, panel_factor)

__all__ = ["panel_factor", "apply_panel", "slogdet_condense_blocked",
           "parallel_slogdet_mc_blocked"]


def parallel_slogdet_mc_blocked(mesh, *, k: int = 32,
                                lookahead: bool = False):
    """Parallel blocked condensation over a 1-D mesh: the engine route
    ``(schedule="mesh", update="panel")``.  Rank ``p`` factorizes panels
    of ``k`` of its own rows (K4), broadcasts ``(R, ls)`` once per panel,
    and every rank applies the rank-k update (K2) to its live rows;
    remainder rows take the rank-1 schedule, then the P x P tail.
    ``lookahead=True`` factors panel g + 1 from an early-applied copy and
    issues its broadcast before the bulk update of panel g
    (bit-identical results)."""
    return build_mesh(EngineConfig(schedule="mesh", update="panel",
                                   panel_k=k, lookahead=lookahead), mesh)
