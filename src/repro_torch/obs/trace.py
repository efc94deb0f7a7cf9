"""Wall-time trace spans with thread-local nesting.

Counterpart of `repro.obs.trace`.  Two context managers:

:func:`span`
    Host wall-time span around a call (plan build, execute, backward).
    ``sync=`` a device or tensor waits for the card
    (`torch.cuda.synchronize`) before the clock stops, in every mode, as
    the JAX package's ``block_until_ready`` does.

:func:`stage`
    For the engine's and the kernels' steps, which run eagerly once per
    row or panel.  With obs ``off`` or ``metrics`` it returns ONE shared
    no-op object: no allocation, no range, no host read on the per-row
    loops.  In ``trace`` mode it records a span event and opens a
    `torch.profiler.record_function` range of the same name, and an NVTX
    range when CUDA is in use, so that a profiler or NVTX trace of the
    card shows the stage around its launches.  The recorded duration is
    the host's time in the stage: on the card that is enqueue time, the
    kernels themselves run asynchronously (their time comes from the
    profiler's device events).

Events use the Chrome-trace "complete" (``ph: "X"``) model: name,
category, start timestamp and duration in microseconds, plus the nesting
depth at record time.  The buffer is bounded; overflow bumps a
dropped-events counter rather than growing without limit.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs import config as _cfg

_EPOCH = time.perf_counter()      # process-relative origin for timestamps
_MAX_EVENTS = 100_000

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_dropped = 0
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def _record(name: str, cat: str, ts_us: float, dur_us: float, depth: int,
            args: Optional[Dict[str, Any]]) -> None:
    global _dropped
    ev = {"name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
          "depth": depth, "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
        else:
            _events.append(ev)


class _Null:
    """The shared no-op context of the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _sync(target) -> None:
    dev = target.device if isinstance(target, torch.Tensor) \
        else torch.device(target)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Span:
    """A recorded span: host clock, `record_function` range, and an NVTX
    range when CUDA is in use."""
    __slots__ = ("name", "cat", "sync", "attrs", "depth", "t0", "rf", "nvtx")

    def __init__(self, name: str, cat: str, sync, attrs: dict):
        self.name, self.cat, self.sync, self.attrs = name, cat, sync, attrs

    def __enter__(self):
        st = _stack()
        self.depth = len(st)
        st.append(self.name)
        self.nvtx = torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = _now_us()
        return None

    def __exit__(self, *exc):
        try:
            if self.sync is not None:
                _sync(self.sync)
        finally:
            t1 = _now_us()
            self.rf.__exit__(*exc)
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            _stack().pop()
            _record(self.name, self.cat, self.t0, t1 - self.t0, self.depth,
                    self.attrs or None)
        return False


class _SyncOnly:
    __slots__ = ("target",)

    def __init__(self, target):
        self.target = target

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        _sync(self.target)
        return False


def span(name: str, *, cat: str = "host", sync: Any = None, **attrs: Any):
    """Wall-time span around host code (recorded in ``trace`` mode).

    ``sync`` -- a device or a tensor (its device): the card is
    synchronized before the clock stops, in every mode, so the span
    covers the device work dispatched inside it rather than dispatch
    alone.
    """
    if _cfg._STATE.level < 2:
        return _NULL if sync is None else _SyncOnly(sync)
    return _Span(name, cat, sync, attrs)


def stage(name: str, **attrs: Any):
    """Scope of one engine or kernel step (see the module docstring): the
    shared no-op object unless obs is ``trace``."""
    if _cfg._STATE.level < 2:
        return _NULL
    return _Span(name, "stage", None, attrs)


def events() -> List[Dict[str, Any]]:
    """Snapshot of recorded span events (oldest first)."""
    with _lock:
        return list(_events)


def dropped_events() -> int:
    with _lock:
        return _dropped


def reset() -> None:
    """Clear the event buffer (test hook)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0
