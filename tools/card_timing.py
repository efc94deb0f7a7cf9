"""Device time of calls shorter than the host's enqueue, on one card.

``queued_ms(fn)`` calls ``fn`` a few times, then enqueues ``iters``
calls behind a kernel that sleeps about 20 ms and times them between two
CUDA events: the card starts them only once the host has enqueued them
all, so the time is the card's, not the host's.  It raises if the
enqueue outlasted the sleep, which would let the host's time in again.
``queued_times(fn)`` also returns the host's enqueue time per call.
Used by ``tools/k2_variants.py`` and ``tools/panel_route_time.py``.
"""
from __future__ import annotations

import time

SLEEP_CYCLES = 40_000_000   # about 20 ms at the H100's clock
_sleep_ms: list[float] = []


def sleep_ms() -> float:
    """The sleeping kernel's length on this card (measured once)."""
    import torch
    if not _sleep_ms:
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        s1.record()
        torch.cuda.synchronize()
        _sleep_ms.append(s0.elapsed_time(s1))
    return _sleep_ms[0]


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one of ``iters`` calls of ``fn`` queued behind
    a sleeping kernel."""
    return queued_times(fn, iters, warmup)[0]


def queued_times(fn, iters: int = 20, warmup: int = 3):
    """``(device ms, host ms)`` per call of ``fn``: the device time as
    `queued_ms` takes it, and the host's time to enqueue one call."""
    import torch
    limit = sleep_ms()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= limit:
        raise RuntimeError(f"enqueue took {host_ms} ms, longer than the "
                           f"{limit} ms sleep: raise SLEEP_CYCLES")
    return start.elapsed_time(end) / iters, host_ms / iters
