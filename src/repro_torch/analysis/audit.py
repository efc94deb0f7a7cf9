"""Audit drivers: record a plan's call (or a whole plan grid, or an
exported plan artifact dir) and run the registered passes over it.

Counterpart of `repro.analysis.audit`.  The JAX package lowers a plan
without running it; the port RUNS the plan once under the op recorder
(`analysis.ir.Recorder`) on an input made from a fixed numpy seed at the
plan's shape, dtype and device (SPD, so the estimators are defined), and
with ``include_grad`` records ``plan.value_and_grad`` on it as well.

The split of recordings mirrors the JAX split between lowered and
compiled text: most passes read a recording made in the caller's obs
mode; ``stage-coverage`` reads scopes, which exist only in ``trace``
mode, so for an exact plan the driver records the forward a second time
under ``trace`` and restores the caller's mode (and trace buffer).

`audit_plan` is the core; `LogdetPlan.audit()` delegates here.  The CLI
(`python -m repro_torch.analysis`) wraps `audit_grid` / `audit_aot_dir` /
`repro_torch.analysis.lint.lint_paths`.  Each recording's op count, host
reads, kernel records, collectives, the kernels' launch counters over
the same call, its seconds and its result (sign, log|det|, sem, read
after the recording) are kept in the report's ``meta["recordings"]``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.ir import Recorder
from repro_torch.analysis.passes import (
    PASSES, AuditContext, DEFAULT_PASS_IDS, run_passes,
)
from repro_torch.analysis.report import AuditReport, Finding

__all__ = ["PlanAuditError", "audit_plan", "audit_grid", "default_grid",
           "audit_artifact", "audit_aot_dir", "context_for",
           "audit_input"]

# the audit input's numpy seed
AUDIT_SEED = 0
# columns of the audit input's factor
_INPUT_RANK = 64
# time limit of the grid's mesh ranks
_GRID_TIMEOUT_S = 600.0


class PlanAuditError(ValueError):
    """The plan has no single program to audit."""


# --------------------------------------------------------------------------
# plan -> AuditContext
# --------------------------------------------------------------------------

def context_for(plan, kind: str = "forward") -> AuditContext:
    """Derive the pass inputs from a live `LogdetPlan` (the JAX labels:
    ``exact:staged/panel/fused/bf16``, ``slq backward``, ...)."""
    from repro_torch import obs
    from repro_torch.core.configs import ExactConfig
    from repro_torch.estimators import ESTIMATOR_METHODS

    spec, cfg = plan.spec, plan.config
    schedule = update = None
    lookahead, panel_k = False, 32
    fused, precision = False, None
    shrink, min_size = 0.75, 64
    if isinstance(cfg, ExactConfig):
        ecfg = cfg.engine_config() if plan.method == "exact" else None
        if ecfg is not None:
            schedule, update = ecfg.schedule, ecfg.update
            lookahead, panel_k = ecfg.lookahead, ecfg.panel_k
            fused, precision = ecfg.fused, ecfg.precision
            shrink, min_size = ecfg.shrink, ecfg.min_size
    n = plan.diagnostics.padded_n or spec.n
    label = plan.method if schedule is None else \
        (f"{plan.method}:{schedule}/{update}"
         + ("/la" if lookahead else "")
         + ("/fused" if fused else "")
         + (f"/{precision}" if precision else ""))
    if kind != "forward":
        label = f"{label} {kind}"
    return AuditContext(
        label=label, method=plan.method, kind=kind,
        schedule=schedule, update=update, lookahead=lookahead,
        panel_k=panel_k, fused=fused, precision=precision, n=n,
        devices=plan.diagnostics.device_count or 1,
        itemsize=getattr(torch, spec.dtype).itemsize, dtype=spec.dtype,
        obs_mode=obs.mode(),
        matrix_free=plan.method in ESTIMATOR_METHODS,
        shrink=shrink, min_size=min_size,
        validate=bool(plan.validate) and spec.kind != "operator")


# --------------------------------------------------------------------------
# plan -> recordings
# --------------------------------------------------------------------------

def audit_input(plan) -> torch.Tensor:
    """The audit's input: ``x x^T / m + 2 I``, x (n, m) from numpy seed
    `AUDIT_SEED` (m = min(n, 64): cheap at full width), at the plan's
    shape (a stack: one per matrix), dtype and device."""
    spec = plan.spec
    rng = np.random.default_rng(AUDIT_SEED)
    m = min(spec.n, _INPUT_RANK)
    x = torch.from_numpy(rng.standard_normal(
        (spec.batch or 1, spec.n, m))).to(plan.device)
    a = x @ x.mT / max(m, 1)                # the product on the device
    a.diagonal(dim1=-2, dim2=-1).add_(2.0)
    a = a if spec.batch is not None else a[0]
    return a.to(getattr(torch, spec.dtype)).contiguous()


def _check_auditable(plan) -> None:
    from repro_torch.estimators import ESTIMATOR_METHODS
    if plan.spec.kind == "operator":
        raise PlanAuditError(
            "operator plans compose the operator's own executables and "
            "have no single program to audit; audit a dense plan of the "
            "materialized matrix instead")
    if plan.method in ESTIMATOR_METHODS and plan._mesh is not None:
        raise PlanAuditError(
            f"plan (method={plan.method!r}, mesh=True) composes eager "
            "executables at run time and has no single program to audit")


def _record(plan, x, kind: str, mode: Optional[str] = None):
    """Record one call (``kind`` "forward": ``plan(x)``; "backward":
    ``plan.value_and_grad(x)``) -> (module, its AuditContext, stats).
    ``mode`` switches obs for the call and restores it, and the trace
    buffer, after; such a recording (for the scope passes) keeps the
    scopes alone."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as _trace

    prev = obs.mode()
    if mode is not None:
        with _trace._lock:
            saved = (list(_trace._events), _trace._dropped)
        obs.configure(mode)
    card = plan.device.type == "cuda"
    try:
        if card:
            torch.cuda.synchronize(plan.device)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with Recorder(ops=mode is None) as mod:
            out = plan(x) if kind == "forward" else plan.value_and_grad(x)
        if card:
            torch.cuda.synchronize(plan.device)
        seconds = time.perf_counter() - t0
        after = ops.launch_counts()
        ctx = context_for(plan, kind=kind)
    finally:
        if mode is not None:
            obs.configure(prev)
            with _trace._lock:
                _trace._events[:] = saved[0]
                _trace._dropped = saved[1]
    if kind == "backward":
        import dataclasses
        ctx = dataclasses.replace(ctx, cg_iters=out[0].diagnostics.cg_iters)
    reads = mod.host_reads()
    res = out if kind == "forward" else out[0]
    stats = {
        "label": ctx.label, "kind": kind, "obs": ctx.obs_mode,
        "ops": len(mod.instructions), "host_reads": len(reads),
        "host_read_sites": sorted({i.site for i in reads}),
        "kernels": mod.kernel_counts(),
        "launches": {k: after[k] - before[k] for k in after
                     if after[k] != before[k]},
        "collectives": {c: sum(1 for i in mod.collectives()
                               if i.opcode == c)
                        for c in sorted({i.opcode
                                         for i in mod.collectives()})},
        "scopes": sorted(mod.scope_names()),
        "seconds": seconds,
        "result": [res.sign.tolist(), res.logabsdet.tolist(),
                   res.sem.tolist()]}
    return mod, ctx, stats


# --------------------------------------------------------------------------
# core driver
# --------------------------------------------------------------------------

def audit_plan(plan, pass_ids: Optional[Sequence[str]] = None,
               include_grad: bool = False) -> AuditReport:
    """Audit a `LogdetPlan` by recording one call -> `AuditReport`.

    Records the forward on `audit_input` (and, with ``include_grad``,
    ``value_and_grad``) and runs the selected passes (default:
    `DEFAULT_PASS_IDS`).  A mesh plan records on every rank, so every
    rank must call this together.  Raises `PlanAuditError` for plans with
    no single program (operator inputs, sharded-estimator composites).
    """
    ids = tuple(pass_ids) if pass_ids is not None else DEFAULT_PASS_IDS
    for p in ids:
        PASSES[p]                       # unknown ids raise KeyError
    _check_auditable(plan)
    x = audit_input(plan)
    report = AuditReport()
    recordings = report.meta.setdefault("recordings", [])
    any_ids = tuple(p for p in ids if PASSES[p].wants != "scopes")
    scope_ids = tuple(p for p in ids if PASSES[p].wants == "scopes")
    for kind in ("forward", "backward") if include_grad else ("forward",):
        if any_ids or not scope_ids:
            mod, ctx, stats = _record(plan, x, kind)
            recordings.append(stats)
            report.extend(run_passes(mod, ctx, any_ids))
            del mod
        if scope_ids and kind == "forward" and plan.method == "exact":
            mod, ctx, stats = _record(plan, x, kind, mode="trace")
            recordings.append(stats)
            report.extend(run_passes(mod, ctx, scope_ids))
            del mod
        elif scope_ids:
            # keep passes_run honest: selected but structurally inapplicable
            for p in scope_ids:
                if p not in report.passes_run:
                    report.passes_run.append(p)
    report.meta.setdefault("plans", []).append(context_for(plan).label)
    return report


# --------------------------------------------------------------------------
# grid driver (the CLI's --grid / --all)
# --------------------------------------------------------------------------

def default_grid(n: int = 32, panel_k: int = 8) -> List[dict]:
    """The audit matrix from the CI contract: every engine route
    (serial|staged|mesh x rank1|panel x lookahead on/off), the fused
    one-pass and bf16 mixed-precision engine variants, plus the
    estimator methods with their backward passes."""
    entries = []
    for schedule in ("serial", "staged", "mesh"):
        for update in ("rank1", "panel"):
            for la in ((False, True) if schedule == "mesh" else (False,)):
                entries.append(dict(method="exact", schedule=schedule,
                                    update=update, lookahead=la, n=n,
                                    k=panel_k))
    # the PR-10 engine variants: one-pass fused steps (serial/staged
    # only) and the quantized-GEMM route, alone and combined
    entries.append(dict(method="exact", schedule="staged", update="rank1",
                        n=n, k=panel_k, fused=True))
    entries.append(dict(method="exact", schedule="staged", update="panel",
                        n=n, k=panel_k, fused=True, precision="bf16"))
    entries.append(dict(method="exact", schedule="staged", update="panel",
                        n=n, k=panel_k, precision="bf16"))
    for method in ("chebyshev", "slq"):
        entries.append(dict(method=method, n=n, grad=True,
                            num_probes=4, seed=0))
    return entries


def _audit_entries(entries, pass_ids, n: int, device, mesh) -> AuditReport:
    """Plan and audit each entry on ``device`` (or ``mesh``)."""
    from repro_torch.core.plan import plan as make_plan

    report = AuditReport()
    for entry in entries:
        entry = dict(entry)
        grad = entry.pop("grad", False)
        size = entry.pop("n", n)
        method = entry.pop("method")
        kw = {"mesh": mesh} if entry.get("schedule") == "mesh" \
            else {"device": device}
        if method == "chebyshev":
            entry.setdefault("degree", 8)
        if method == "slq":
            entry.setdefault("num_steps", 8)
        p = make_plan((size, size), method=method, **kw, **entry)
        report.extend(audit_plan(p, pass_ids=pass_ids, include_grad=grad))
    return report


def _grid_rank(mesh, entries, pass_ids, n: int) -> str:
    """One rank of `audit_grid`'s mesh entries; returns its report's
    JSON."""
    return _audit_entries(entries, pass_ids, n, None, mesh).to_json()


def audit_grid(entries: Optional[List[dict]] = None,
               pass_ids: Optional[Sequence[str]] = None,
               n: int = 32, *, device=None, ranks: int = 1,
               mesh=None) -> AuditReport:
    """Plan and audit every grid entry; one merged `AuditReport`.

    Entries on one device run here on ``device`` (None: the card); the
    mesh entries run in ``ranks`` spawned processes over gloo on the same
    device type (`core.mesh.run_ranks`: on one card its ranks share it),
    and the ranks' reports merge, a finding made on several ranks kept
    once.  Entries keep their order; the mesh ones report last.

    With ``mesh`` (a `core.mesh.Mesh` whose every rank calls this) the
    whole grid runs on this rank, on ``mesh.device``, and nothing is
    spawned: the caller's ranks are the grid's.
    """
    from repro_torch.core.mesh import run_ranks
    from repro_torch.estimators.operators.base import resolve_device

    entries = entries if entries is not None else default_grid(n=n)
    if mesh is not None:
        return _audit_entries(entries, pass_ids, n, mesh.device, mesh)
    dev = resolve_device(device)
    single = [e for e in entries if e.get("schedule") != "mesh"]
    meshed = [e for e in entries if e.get("schedule") == "mesh"]
    report = AuditReport()
    if single:
        report.extend(_audit_entries(single, pass_ids, n, dev, None))
    if meshed:
        texts = run_ranks(_grid_rank, ranks, backend="gloo",
                          device=dev.type, timeout=_GRID_TIMEOUT_S,
                          args=(meshed, tuple(pass_ids) if pass_ids
                                else None, n))
        # the ranks' reports, in order; one finding per (rank-free) identity
        merged = AuditReport()
        for text in texts:
            merged.extend(AuditReport.from_json(text))
        seen, findings = set(), []
        for f in merged.findings:
            key = (f.pass_id, f.severity, f.message, f.where, f.context,
                   f.code)
            if key not in seen:
                seen.add(key)
                findings.append(f)
        merged.findings = findings
        report.extend(merged)
        report.meta["ranks"] = ranks
    return report


# --------------------------------------------------------------------------
# plan artifact audit (the CLI's --aot)
# --------------------------------------------------------------------------

def audit_artifact(path, pass_ids: Optional[Sequence[str]] = None, *,
                   device=None) -> AuditReport:
    """Audit one exported plan artifact on ``device`` (None: the card).

    The artifact holds the resolved plan, no program (`serve.aot`), so
    the audit loads it and records one call with the default passes less
    ``stage-coverage``.  A device-fingerprint mismatch is reported as a
    finding (the plan cannot be safely loaded here), not an exception --
    an audit sweep over a mixed artifact dir should keep going."""
    from repro_torch import obs
    from repro_torch.estimators import ESTIMATOR_METHODS
    from repro_torch.serve.aot import (
        PlanFingerprintError, check_fingerprint, load_plan, read_header,
    )

    path = str(path)
    header = read_header(path)
    spec = header["spec"]
    method = header["method"]
    ecfg = header.get("config", {})
    label = f"aot:{method}:n{spec['n']}"
    report = AuditReport(contexts=[label])
    try:
        check_fingerprint(header, path, device)
    except PlanFingerprintError as exc:
        report.findings.append(Finding(
            pass_id="aot-fingerprint", severity="warning", context=label,
            message=str(exc), where=path))
        return report

    plan = load_plan(path, validate=True, check_device=False, device=device)
    ids = tuple(pass_ids) if pass_ids is not None else DEFAULT_PASS_IDS
    ids = tuple(p for p in ids if p != "stage-coverage")
    x = audit_input(plan)
    mod, live, stats = _record(plan, x, "forward")
    ctx = AuditContext(
        label=label, method=method, kind="export",
        schedule=ecfg.get("schedule"), update=ecfg.get("update"),
        lookahead=bool(ecfg.get("lookahead")),
        panel_k=int(ecfg.get("k") or 32),
        fused=bool(ecfg.get("fused")), precision=ecfg.get("precision"),
        n=int(header.get("padded_n") or spec["n"]),
        itemsize=getattr(torch, spec["dtype"]).itemsize,
        dtype=spec["dtype"], obs_mode=obs.mode(),
        matrix_free=method in ESTIMATOR_METHODS, validate=live.validate)
    report.meta["recordings"] = [dict(stats, label=label, kind="export")]
    report.extend(run_passes(mod, ctx, ids))
    return report


def audit_aot_dir(dirpath, pass_ids: Optional[Sequence[str]] = None, *,
                  device=None) -> AuditReport:
    """Audit every port plan artifact (magic-tagged file) in a dir."""
    from pathlib import Path
    from repro_torch.serve.aot import _MAGIC

    report = AuditReport()
    found = 0
    for f in sorted(Path(dirpath).iterdir()):
        if not f.is_file():
            continue
        with open(f, "rb") as fh:
            if fh.read(len(_MAGIC)) != _MAGIC:
                continue
        found += 1
        report.extend(audit_artifact(f, pass_ids=pass_ids, device=device))
    report.meta["artifacts"] = found
    if not found:
        report.findings.append(Finding(
            pass_id="aot-scan", severity="warning", context="aot",
            message=f"no plan artifacts found under {dirpath}",
            where=str(dirpath)))
    return report
