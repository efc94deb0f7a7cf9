"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of `repro.obs.metrics` (pure Python there too; the port keeps
its own copy).  Zero-dependency and deliberately small.  Metrics are keyed by
``(name, sorted(labels))``; names are dotted (``plan.cache.hits``) and
mangled to Prometheus form only at export time.  All mutation goes
through one lock -- call sites are host-side (plan build/execute, cache
lookups, kernel dispatch), so the lock is uncontended in practice but
makes the ``/metrics`` endpoint thread safe.

Everything is a no-op unless ``REPRO_OBS`` is ``metrics`` or ``trace``.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import config as _cfg

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]

_lock = threading.Lock()
_counters: Dict[_Key, float] = {}
_gauges: Dict[_Key, float] = {}
_hists: Dict[_Key, Dict[str, float]] = {}

# bounded per-histogram sample reservoirs backing `quantile`; kept out of
# the histogram summary dicts so snapshot()/prometheus output is unchanged
_RESERVOIR = 2048
_samples: Dict[_Key, List[float]] = {}


def _key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    """Increment a counter (creates it at 0 on first touch)."""
    if not _cfg.metrics_enabled():
        return
    k = _key(name, labels)
    with _lock:
        _counters[k] = _counters.get(k, 0.0) + value


def set_gauge(name: str, value: float, **labels: Any) -> None:
    if not _cfg.metrics_enabled():
        return
    k = _key(name, labels)
    with _lock:
        _gauges[k] = float(value)


def observe(name: str, value: float, **labels: Any) -> None:
    """Record one observation into a histogram (count/sum/min/max)."""
    if not _cfg.metrics_enabled():
        return
    v = float(value)
    if math.isnan(v):
        return
    k = _key(name, labels)
    with _lock:
        h = _hists.get(k)
        if h is None:
            h = _hists[k] = {"count": 0.0, "sum": 0.0,
                             "min": math.inf, "max": -math.inf}
        h["count"] += 1
        h["sum"] += v
        h["min"] = min(h["min"], v)
        h["max"] = max(h["max"], v)
        s = _samples.setdefault(k, [])
        s.append(v)
        if len(s) > _RESERVOIR:
            # deterministic decimation: keep every other sample.  Coarser
            # than true reservoir sampling but reproducible, and fine for
            # the p50/p99 operational readouts this backs.
            _samples[k] = s[::2]


def quantile(name: str, q: float, **labels: Any) -> Optional[float]:
    """Linear-interpolated quantile over a histogram's sample reservoir.

    ``q`` in [0, 1].  Returns ``None`` when nothing has been observed
    (including when metrics are disabled).  Backed by a bounded reservoir
    (the last ~``_RESERVOIR`` observations, decimated), so treat it as an
    operational readout, not an exact statistic.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    with _lock:
        s = _samples.get(_key(name, labels))
        if not s:
            return None
        s = sorted(s)
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def counter_value(name: str, **labels: Any) -> float:
    """Read a counter (0.0 if never incremented) -- test/report hook."""
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def snapshot() -> Dict[str, Dict[str, Any]]:
    """A plain-dict copy of the whole registry.

    Keys are rendered as ``name`` or ``name{k=v,...}``; histograms map
    to their summary dicts.
    """

    def render(k: _Key) -> str:
        name, labels = k
        if not labels:
            return name
        inner = ",".join(f"{lk}={lv}" for lk, lv in labels)
        return f"{name}{{{inner}}}"

    with _lock:
        return {
            "counters": {render(k): v for k, v in _counters.items()},
            "gauges": {render(k): v for k, v in _gauges.items()},
            "histograms": {render(k): dict(v) for k, v in _hists.items()},
        }


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    # the port's own prefix: a scrape of both packages keeps them apart
    return "repro_torch_" + "".join(out)


def _prom_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def prometheus_text() -> str:
    """Render the registry in Prometheus text exposition format."""
    lines: List[str] = []
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        hists = {k: dict(v) for k, v in _hists.items()}
    seen_type: Dict[str, str] = {}

    def header(pname: str, kind: str) -> None:
        if seen_type.get(pname) != kind:
            seen_type[pname] = kind
            lines.append(f"# TYPE {pname} {kind}")

    for (name, labels), v in sorted(counters.items()):
        pname = _prom_name(name) + "_total"
        header(pname, "counter")
        lines.append(f"{pname}{_prom_labels(labels)} {v:g}")
    for (name, labels), v in sorted(gauges.items()):
        pname = _prom_name(name)
        header(pname, "gauge")
        lines.append(f"{pname}{_prom_labels(labels)} {v:g}")
    for (name, labels), h in sorted(hists.items()):
        pname = _prom_name(name)
        header(pname, "summary")
        lab = _prom_labels(labels)
        lines.append(f"{pname}_count{lab} {h['count']:g}")
        lines.append(f"{pname}_sum{lab} {h['sum']:g}")
        if h["count"]:
            lines.append(f"{pname}_min{lab} {h['min']:g}")
            lines.append(f"{pname}_max{lab} {h['max']:g}")
    return "\n".join(lines) + ("\n" if lines else "")


def reset() -> None:
    """Clear the registry (test hook)."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _hists.clear()
        _samples.clear()
