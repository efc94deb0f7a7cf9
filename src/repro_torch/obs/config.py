"""Observability mode state.

Counterpart of `repro.obs.config` (pure Python there too; the port keeps
its own copy).  One process-wide switch, three levels::

    off      nothing recorded, no hook on the hot loops     (default)
    metrics  counters / gauges / histograms only
    trace    metrics + wall-time spans + `torch.profiler` / NVTX ranges
             + convergence telemetry

Configured by the ``REPRO_OBS`` environment variable at import, or at
runtime via :func:`configure`.  The variable is parsed strictly: a typo
fails fast with the valid choices.

Levels are ordered: ``trace`` implies ``metrics``.  Call sites gate with
:func:`metrics_enabled` / :func:`trace_enabled`: an attribute read and an
int compare.
"""
from __future__ import annotations

import os

ENV_VAR = "REPRO_OBS"
ENV_DIR = "REPRO_OBS_DIR"

MODES = ("off", "metrics", "trace")
_LEVEL = {"off": 0, "metrics": 1, "trace": 2}


def _parse(raw: str, *, source: str) -> str:
    mode = raw.strip().lower()
    if mode not in MODES:
        raise ValueError(f"{source}={raw!r}: choose one of {MODES}")
    return mode


class _State:
    __slots__ = ("mode", "level", "out_dir")

    def __init__(self) -> None:
        self.mode = _parse(os.environ.get(ENV_VAR) or "off", source=ENV_VAR)
        self.level = _LEVEL[self.mode]
        self.out_dir = os.environ.get(ENV_DIR) or "obs_out"


_STATE = _State()


def mode() -> str:
    """Current observability mode: ``off`` | ``metrics`` | ``trace``."""
    return _STATE.mode


def out_dir() -> str:
    """Directory the atexit exporters write to (``REPRO_OBS_DIR``)."""
    return _STATE.out_dir


def metrics_enabled() -> bool:
    return _STATE.level >= 1


def trace_enabled() -> bool:
    return _STATE.level >= 2


def configure(mode: str | None = None, *, out_dir: str | None = None) -> str:
    """Set the observability mode (and/or export dir) at runtime; returns
    the active mode.  Eager PyTorch has no staged code, so the new mode
    applies from the next call on."""
    if mode is not None:
        _STATE.mode = _parse(mode, source="configure(mode=...)")
        _STATE.level = _LEVEL[_STATE.mode]
    if out_dir is not None:
        _STATE.out_dir = out_dir
    return _STATE.mode
