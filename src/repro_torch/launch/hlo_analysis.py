"""Compatibility shim -- counterpart of `repro.launch.hlo_analysis`: the
collective accounting and the roofline live in `repro_torch.analysis.ir`.

The public surface is the JAX module's; ``HW`` holds the H100's data
sheet (`analysis.ir`), and ``collective_bytes`` reads a recorded op
stream (`analysis.ir.record`) where the JAX one parses HLO text.
"""
from __future__ import annotations

from repro_torch.analysis.ir import (  # noqa: F401
    HW, CollectiveStats, collective_bytes, roofline,
)

__all__ = ["collective_bytes", "roofline", "HW", "CollectiveStats"]
