"""repro_torch.obs -- tracing, metrics and convergence telemetry.

Counterpart of `repro.obs`, with the same public names.  Three modes via
``REPRO_OBS=off|metrics|trace`` (default ``off``), parsed strictly:

==========  ==========================================================
``off``     nothing recorded: `stage` returns one shared no-op object,
            so the engine's per-row loops carry no range, no allocation
            and no host read
``metrics`` counters / gauges / histograms (plan-cache hits, plan
            executions, probes, CG iterations, kernel dispatches, ...)
``trace``   metrics + host wall-time spans, each stage also a
            `torch.profiler.record_function` range and (CUDA in use) an
            NVTX range, + convergence telemetry copied to the host;
            artifacts written to ``REPRO_OBS_DIR`` (default
            ``obs_out/``) at exit as ``torch_trace.json``,
            ``torch_events.jsonl`` and ``torch_metrics.prom``
==========  ==========================================================

The JAX package's ``plan.traces`` / ``plan.retraces`` counters and its
``plan.compile`` span count jit traces; eager PyTorch has none, so the
port records neither.  Public surface::

    with obs.span("plan.build"):          # host wall-time span
        ...
    with obs.stage("engine.pivot"):       # span + profiler / NVTX range
        ...
    obs.inc("plan.cache.hits")            # metrics
    obs.emit_curve("slq.sem", curve)      # telemetry (trace mode only)
    obs.export_chrome_trace("t.json")     # Perfetto-loadable
"""
from repro_torch.obs.config import (
    ENV_DIR, ENV_VAR, MODES, configure, metrics_enabled, mode, out_dir,
    trace_enabled,
)
from repro_torch.obs.export import (
    ARTIFACTS, add_metrics_cli, chrome_trace, export_chrome_trace,
    export_jsonl, export_metrics, install_atexit, start_metrics_from_args,
    start_metrics_server, validate_chrome_trace, write_all,
)
from repro_torch.obs.metrics import (
    counter_value, inc, observe, prometheus_text, quantile, set_gauge,
    snapshot,
)
from repro_torch.obs.telemetry import (
    drain as drain_telemetry, emit_curve, emit_point, flush as flush_telemetry,
    running_sem,
)
from repro_torch.obs.trace import dropped_events, events, span, stage

__all__ = [
    "configure", "mode", "out_dir", "metrics_enabled", "trace_enabled",
    "MODES", "ENV_VAR", "ENV_DIR", "ARTIFACTS",
    "span", "stage", "events", "dropped_events",
    "inc", "set_gauge", "observe", "counter_value", "snapshot",
    "prometheus_text", "quantile",
    "emit_curve", "emit_point", "running_sem", "drain_telemetry",
    "flush_telemetry",
    "chrome_trace", "export_chrome_trace", "export_jsonl", "export_metrics",
    "validate_chrome_trace", "write_all", "start_metrics_server",
    "add_metrics_cli", "start_metrics_from_args",
    "install_atexit", "reset",
]


def reset() -> None:
    """Clear spans, metrics and telemetry buffers (test hook)."""
    from repro_torch.obs import metrics as _m, telemetry as _t, trace as _tr
    _tr.reset()
    _m.reset()
    _t.reset()


# REPRO_OBS set in the environment -> dump artifacts at interpreter exit.
if mode() != "off":
    install_atexit()
