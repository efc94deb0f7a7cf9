"""Serial matrix condensation (paper §1-§2.4): the engine's rank-1 routes
under their historical names.

Counterpart of `repro.core.condense`: the step logic lives in one place,
`repro_torch.core.engine`; these are thin wrappers over its
``(schedule="serial"|"staged", update="rank1")`` routes.

  * `slogdet_condense`         one buffer, every step on the live block.
  * `slogdet_condense_staged`  geometric stages over shrinking buffers.

See core/blocked.py for the rank-K panel routes and core/parallel.py for
the mesh schedule.
"""
from __future__ import annotations

from repro_torch.core.engine import (
    combine_slogdet,
    condense_full as slogdet_condense,
    condense_steps,
    staged_full,
)

__all__ = [
    "slogdet_condense",
    "slogdet_condense_staged",
    "condense_steps",
    "combine_slogdet",
]


def slogdet_condense_staged(a, *, shrink: float = 0.75, min_size: int = 64):
    """Geometric shape-staged condensation: engine route
    ``(schedule="staged", update="rank1")``."""
    return staged_full(a, shrink=shrink, min_size=min_size, update="rank1")
