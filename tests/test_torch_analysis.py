"""repro_torch.analysis -- the op recorder, the checker passes, the lint,
the audit drivers and the CLI, on the CPU, against the JAX package's
`repro.analysis`.

* **report**: the same findings give the same idents and JSON in both
  packages, and both packages' allowlist readers waive the same set under
  the JAX ``allowlist.toml``.
* **lint**: ``unused-config-kwarg`` and ``deprecated-route`` over
  ``src/repro`` give identical ``(rule, where, code)`` in both packages;
  the two rules that name JAX calls in the JAX package are held on
  planted torch sources; the port's tree lints clean under its own
  allowlist.
* **passes**: every registered pass fails on a planted fault and stays
  clean on the real recording, each on a recorded `Module`.  The planted
  host read inside an exact loop has no JAX counterpart: the JAX
  ``no-host-callback`` pass is blind to host callbacks under jax 0.9
  (ROADMAP Queue 3).
* **audit**: `default_grid` and the ``context_for`` labels equal the JAX
  ones; the stage map equals the JAX map at every grid geometry on the
  JAX names; `audit_grid(n=32)` is clean with the JAX ``passes_run``,
  mesh at P = 1 and 2 in gloo ranks; recording changes no bit of any
  route's result.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.analysis as janalysis
from repro.analysis import audit as jaudit
from repro.core.plan import plan as jax_plan

import test_torch_ranks as ranks

import repro_torch
from repro_torch import analysis, obs
from repro_torch.analysis import (
    AuditContext, AuditReport, DEFAULT_ALLOWLIST, DEFAULT_PASS_IDS, Finding,
    PASSES, PlanAuditError, Recorder, apply_allowlist, audit_aot_dir,
    audit_artifact, audit_grid, default_grid, expected_engine_stages,
    lint_paths, lint_source, load_allowlist, record, run_passes,
)
from repro_torch.analysis.audit import context_for
from repro_torch.core.mesh import Mesh, run_ranks
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
N = 32
K = 8
CPU = torch.device("cpu")
MESH1 = Mesh(group=None, size=1, rank=0, device=CPU)


@pytest.fixture(autouse=True)
def obs_off():
    """Tests below flip obs modes; never leak state into other files."""
    obs.configure("off")
    yield
    obs.configure("off")


def _spd(n=N, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return torch.from_numpy(x @ x.T / n + 2.0 * np.eye(n)).to(dtype)


def _plan(**kw):
    kw.setdefault("device", "cpu")
    return repro_torch.plan((N, N), **kw)


# ================================================================== report

FINDINGS = [
    dict(pass_id="no-host-callback", severity="error", message="m",
         where="core/engine.py:_condense_step", context="exact:serial/rank1",
         code="%3 = host.item(f32[])"),
    dict(pass_id="timing-no-block", severity="error", message="t",
         where="repro/serve/service.py:331", context="lint",
         code="_run_group"),
    dict(pass_id="unused-config-kwarg", severity="warning", message="u",
         where="repro/core/plan.py:12", context="lint", code="fwd(key=...)"),
    dict(pass_id="dtype-discipline", severity="info", message="d",
         where="precision=bf16", context="x"),
]


def test_report_idents_and_json_match_jax():
    ours = AuditReport(findings=[Finding(**f) for f in FINDINGS],
                       passes_run=["p"], contexts=["c"], meta={"k": 1})
    theirs = janalysis.AuditReport(
        findings=[janalysis.Finding(**f) for f in FINDINGS],
        passes_run=["p"], contexts=["c"], meta={"k": 1})
    assert [f.ident for f in ours.findings] == \
        [f.ident for f in theirs.findings]
    assert ours.to_json() == theirs.to_json()
    assert ours.summary() == theirs.summary()
    back = AuditReport.from_json(theirs.to_json())
    assert back.findings == ours.findings and not back.ok
    with pytest.raises(ValueError, match="severity"):
        Finding(pass_id="p", severity="fatal", message="m")


def test_allowlists_waive_the_same_findings():
    """Both readers load the JAX allowlist to the same entries and waive
    the same findings; the port's own allowlist loads too."""
    jallow = janalysis.load_allowlist(janalysis.DEFAULT_ALLOWLIST)
    assert load_allowlist(janalysis.DEFAULT_ALLOWLIST) == jallow
    findings = FINDINGS + [
        dict(FINDINGS[1], where="repro/serve/service.py:40",
             code="_drain_loop"),
        dict(FINDINGS[2], code="vag(key=...)"),
    ]
    ours = apply_allowlist(AuditReport(
        findings=[Finding(**f) for f in findings]), jallow)
    theirs = janalysis.apply_allowlist(janalysis.AuditReport(
        findings=[janalysis.Finding(**f) for f in findings]), jallow)
    waived = [f.waived for f in ours.findings]
    assert waived == [f.waived for f in theirs.findings]
    assert sum(waived) == 4
    assert ours.to_json() == theirs.to_json()
    own = load_allowlist(DEFAULT_ALLOWLIST)
    assert own and all(e["reason"].strip()
                       for group in own.values() for e in group)
    assert set(own) <= set(PASSES) | set(analysis.LINT_RULES)


@pytest.mark.parametrize("text,err", [
    ('[[x]]\nwhere = "*"\n', "reason"),
    ('[[x]]\nreason = unquoted\n', "unparseable"),
])
def test_allowlist_rejections_match_jax(tmp_path, text, err):
    path = tmp_path / "allow.toml"
    path.write_text(text)
    with pytest.raises(ValueError, match=err):
        janalysis.load_allowlist(path)
    with pytest.raises(ValueError, match=err):
        load_allowlist(path)
    assert load_allowlist(tmp_path / "absent.toml") == {}


# ==================================================================== lint

@pytest.mark.parametrize("rule", ["unused-config-kwarg", "deprecated-route"])
def test_lint_rules_match_jax_over_the_jax_tree(rule):
    pkg = SRC / "repro"

    def rows(report):
        return sorted((f.pass_id, f.where, f.code) for f in report.findings)

    want = rows(janalysis.lint_paths([pkg], root=SRC, rules=(rule,)))
    got = rows(lint_paths([pkg], root=SRC, rules=(rule,)))
    assert got == want
    if rule == "unused-config-kwarg":
        assert want          # the JAX tree has waived residue


def test_lint_unused_config_kwarg():
    bad = ("def f(a, *, lookahead=False):\n"
           "    return a + 1\n")
    (f,) = lint_source(bad, "m.py", rules=("unused-config-kwarg",))
    assert "lookahead" in f.message and f.where == "m.py:1"
    good = bad.replace("a + 1", "a + int(lookahead)")
    stub = bad.replace("return a + 1", "raise NotImplementedError")
    sink = bad.replace("lookahead", "_unused")
    for src in (good, stub, sink):
        assert not lint_source(src, "m.py", rules=("unused-config-kwarg",))


def test_lint_implicit_dtype_targets_torch():
    (f,) = lint_source("x = torch.zeros((4, 4))\n", "m.py",
                       rules=("implicit-dtype",))
    assert "dtype" in f.message and f.code == "torch.zeros"
    for ctor in ("ones", "full", "eye", "empty"):
        assert lint_source(f"x = torch.{ctor}(4)\n", "m.py",
                           rules=("implicit-dtype",))
    for good in ("x = torch.zeros((4, 4), dtype=a.dtype)\n",
                 "x = torch.zeros_like(a)\n", "x = np.zeros((4, 4))\n",
                 "x = jnp.zeros((4, 4))\n"):
        assert not lint_source(good, "m.py", rules=("implicit-dtype",))


@pytest.mark.parametrize("sync", [
    "    torch.cuda.synchronize()\n",
    "    end.synchronize()\n",
    "    ms = start.elapsed_time(end)\n",
    "    with obs.span('bench', sync=a):\n        pass\n",
])
def test_lint_timing_no_block_takes_torch_syncs(sync):
    bad = ("def bench(f, a):\n"
           "    t0 = time.perf_counter()\n"
           "    f(a)\n"
           "    return time.perf_counter() - t0\n")
    (f,) = lint_source(bad, "m.py", rules=("timing-no-block",))
    assert "synchronize" in f.message and f.code == "bench"
    good = bad.replace("    f(a)\n", "    f(a)\n" + sync)
    assert not lint_source(good, "m.py", rules=("timing-no-block",))
    # the JAX package's sync is no sync for torch
    jaxy = bad.replace("    f(a)\n", "    jax.block_until_ready(f(a))\n")
    assert lint_source(jaxy, "m.py", rules=("timing-no-block",))


def test_lint_deprecated_route():
    bad = "r = slogdet(a, method='pmc')\n"
    (f,) = lint_source(bad, "serve/service.py", rules=("deprecated-route",))
    assert "'pmc'" in f.message
    for definer in ("core/api.py", "core/plan.py", "core/engine.py",
                    "core/configs.py"):
        assert not lint_source(bad, definer, rules=("deprecated-route",))
    assert not lint_source("r = slogdet(a, method='exact')\n", "x.py",
                           rules=("deprecated-route",))


def test_lint_paths_reports_syntax_errors(tmp_path):
    (tmp_path / "ok.py").write_text("x = 1\n")
    (tmp_path / "broken.py").write_text("def f(:\n")
    report = lint_paths([tmp_path], root=tmp_path)
    assert [f.where for f in report.errors] == ["broken.py"]
    assert "unparseable" in report.errors[0].message


def test_port_lint_is_clean_under_its_allowlist():
    pkg = SRC / "repro_torch"
    raw = lint_paths([pkg], root=SRC)
    report = apply_allowlist(raw, load_allowlist(DEFAULT_ALLOWLIST))
    assert report.ok, report.summary()
    # every waiver is in use
    used = {(f.pass_id, f.message.rsplit("[waived: ", 1)[-1][:-1])
            for f in report.findings if f.waived}
    listed = {(pid, e["reason"]) for pid, group in
              load_allowlist(DEFAULT_ALLOWLIST).items() for e in group}
    assert used == listed


def test_import_check_covers_the_analysis_package():
    """tests/test_torch_plan.py's no-JAX check walks src/repro_torch
    recursively: the analysis modules are among its files."""
    files = {p.name for p in (SRC / "repro_torch" / "analysis").rglob("*.py")}
    assert {"ir.py", "passes.py", "lint.py", "audit.py", "report.py",
            "__main__.py"} <= files


# ================================================================ recorder

def test_recorder_sees_ops_kernels_reads_and_scopes():
    a = _spd()
    with Recorder() as mod:
        a.sum().item()
        ops.rank1_update(a, a[:, 0], a[0])
    ops_seen = [i.opcode for i in mod.instructions]
    assert ops_seen[:2] == ["aten.sum", "host.item"]
    assert "kernel.rank1_update" in ops_seen
    k = mod.find("kernel.")[0]
    assert [s.dims for s in k.operand_shapes] == [(N, N), (N,), (N,)]
    assert k.operand_shapes[0].dtype == "f32"
    # the plain version's ATen ops follow the record
    assert ops_seen.index("kernel.rank1_update") < len(ops_seen) - 1
    (read,) = mod.host_reads()
    assert read.site.endswith(":test_recorder_sees_ops_kernels_reads_and_"
                              "scopes") and not mod.entered
    obs.configure("trace")
    with Recorder() as traced:
        with obs.stage("engine.pivot"):
            a.abs()
        with obs.stage("engine.broadcast"):
            pass
    assert traced.scope_names() == {"engine.pivot", "engine.broadcast"}
    assert traced.instructions[0].scopes == ("engine.pivot",)
    assert ops._recorder is None


def test_recording_changes_no_bit_of_any_route():
    """Every route of the default grid on one device, and ge, with and
    without a recorder: the same bits (estimators from the config seed)."""
    a = _spd()
    entries = [e for e in default_grid() if e.get("schedule") != "mesh"]
    entries.append(dict(method="ge"))
    for e in entries:
        e = {k: v for k, v in e.items() if k not in ("n", "grad")}
        p = _plan(**e)
        plain = p(a)
        mod = Recorder()
        with mod:
            recorded = p(a)
        for f in ("sign", "logabsdet", "sem"):
            assert torch.equal(getattr(plain, f), getattr(recorded, f)), e


def test_kernel_records_equal_the_kernel_calls():
    """On the CPU no kernel launches; the plain versions' calls, counted
    at the `ops` entry points, stand for the launch counters."""
    a = _spd()
    names = ("rank1_update", "panel_update", "panel_factor",
             "fused_condense_step")
    for kw in (dict(method="exact", schedule="staged", update="panel", k=K),
               dict(method="exact", schedule="serial", update="rank1"),
               dict(method="exact", schedule="staged", update="rank1",
                    fused=True)):
        calls, restore = ranks._counting(names)
        try:
            mod = record(_plan(**kw), a)
        finally:
            restore()
        want = {{"fused_condense_step": "fused_step"}.get(k, k): v
                for k, v in calls.items() if v}
        assert mod.kernel_counts() == want, kw
    assert mod.kernel_counts() == {"fused_step": N - 1}


# ================================================================== passes

def test_no_dense_factorization_planted_and_clean():
    a = _spd()
    ctx = AuditContext(method="slq", matrix_free=True, n=N)
    bad = run_passes(record(torch.linalg.cholesky, a), ctx,
                     ("no-dense-factorization",))
    assert not bad.ok and "cholesky" in bad.errors[0].message
    for fn in (torch.linalg.inv, torch.linalg.slogdet, torch.linalg.eigh,
               lambda x: torch.linalg.solve_triangular(x, x, upper=True),
               lambda x: ops.panel_factor(x[:K], N)):
        assert not run_passes(record(fn, a), ctx,
                              ("no-dense-factorization",)).ok
    # the exact family is entitled to factorize
    assert run_passes(record(torch.linalg.cholesky, a),
                      AuditContext(method="exact", n=N),
                      ("no-dense-factorization",)).ok
    # SLQ's quadrature eigh on its Lanczos tridiagonal is not A's
    p = _plan(method="slq", num_steps=8, num_probes=4)
    mod = record(p, a)
    assert mod.find("aten._linalg_eigh")
    assert run_passes(mod, context_for(p), ("no-dense-factorization",)).ok


def _leaky_pivots(monkeypatch):
    """A host read planted inside the exact engine's step loop."""
    orig = ops.pivot_operands

    def leaky(buf, t):
        out = orig(buf, t)
        out[1].item()
        return out

    monkeypatch.setattr(ops, "pivot_operands", leaky)


@pytest.mark.parametrize("mode", ["off", "metrics"])
def test_no_host_callback_catches_a_planted_host_read(monkeypatch, mode):
    obs.configure(mode)
    p = _plan(method="exact", schedule="serial", update="rank1")
    assert p.audit(passes=["no-host-callback"]).ok
    _leaky_pivots(monkeypatch)
    report = p.audit(passes=["no-host-callback"])
    (f,) = report.errors
    assert f.where == "core/engine.py:_condense_step"
    assert f.message.startswith(f"{N - 1} host read(s) (host.item)")
    assert report.meta["recordings"][0]["host_reads"] == N - 1


def test_no_host_callback_entitlements():
    """A validating estimator plan reads three scalars once; CG reads once
    per iteration and once to stop; one read more is an error; trace mode
    is not checked (it copies telemetry to the host)."""
    p = _plan(method="chebyshev", degree=8, num_probes=4, grad=True)
    report = p.audit(passes=["no-host-callback"], include_grad=True)
    assert report.ok, report.summary()
    fwd, bwd = report.meta["recordings"]
    assert fwd["host_reads"] == 1 and fwd["host_read_sites"] == \
        ["core/plan.py:_validate_spd_like"]
    assert bwd["host_reads"] > 2
    a = _spd()
    mod = record(lambda: (p(a), a.sum().item()))
    ctx = context_for(p)
    bad = run_passes(mod, ctx, ("no-host-callback",))
    assert len(bad.errors) == 1
    assert run_passes(mod, dataclasses.replace(ctx, obs_mode="trace"),
                      ("no-host-callback",)).ok
    unvalidated = run_passes(record(p, a),
                             dataclasses.replace(ctx, validate=False),
                             ("no-host-callback",))
    assert unvalidated.errors[0].where == "core/plan.py:_validate_spd_like"


def test_dtype_discipline_planted_and_clean():
    a = _spd()
    f32 = AuditContext(dtype="float32")
    bad = run_passes(record(lambda: a.to(torch.float64)), f32,
                     ("dtype-discipline",))
    assert not bad.ok and "upcast" in bad.errors[0].message
    assert run_passes(record(lambda: a.to(torch.float64)),
                      AuditContext(dtype="float64"),
                      ("dtype-discipline",)).ok
    warn = run_passes(record(lambda: torch.ones(3, dtype=torch.float64)),
                      f32, ("dtype-discipline",))
    assert warn.ok and warn.warnings
    p = _plan(method="exact", schedule="staged", update="panel", k=K,
              precision="bf16")
    clean = run_passes(record(p, a), context_for(p), ("dtype-discipline",))
    assert clean.ok and not clean.findings
    # a bf16-context program whose K2 record has f32 operands
    c, r = a[:, :K].contiguous(), a[:K].contiguous()
    inert = run_passes(record(ops.panel_update, a, c, r), context_for(p),
                       ("dtype-discipline",))
    assert not inert.ok and "bf16-silent-upcast" in inert.errors[0].message


def test_stage_coverage_planted_and_clean():
    p = _plan(method="exact", schedule="serial", update="rank1")
    ctx = context_for(p)
    a = _spd()
    missing = run_passes(record(p, a), ctx, ("stage-coverage",))
    assert sorted(f.where for f in missing.errors) == \
        ["engine.pivot", "engine.swap", "engine.update"]
    assert all("inert" in f.message for f in missing.errors)
    obs.configure("trace")
    traced = record(p, a)
    obs.configure("off")
    assert run_passes(traced, ctx, ("stage-coverage",)).ok
    phantom = run_passes(traced, dataclasses.replace(ctx, fused=True),
                         ("stage-coverage",))
    assert sorted((f.where, "forbid" in f.message) for f in phantom.errors) \
        == [("engine.fused_step", False), ("engine.pivot", True),
            ("engine.swap", True), ("engine.update", True)]
    assert PASSES["stage-coverage"].wants == "scopes"
    assert run_passes(traced, AuditContext(method="slq", n=N),
                      ("stage-coverage",)).ok


def test_collective_budget_planted_and_clean_in_ranks():
    """In gloo ranks (P = 2): the real mesh recordings are within budget,
    a broadcast of 2 N P floats is not; off the mesh the pass is silent."""
    results = run_ranks(ranks.planted_collective, 2, backend="gloo",
                        device="cpu", timeout=120, args=(N,))
    p, rows = 2, N // 2
    r = (rows - 1) // K
    for out, ops_seen in results:
        assert ops_seen["rank1"] == ops_seen["panel"] == \
            ["all-reduce", "broadcast"]
        # a broadcast a step ((N + 1) floats) or panel ((K N + K) floats),
        # one all_reduce of the (P, P + 2) tail, twice its bytes on a ring
        tail = 2 * 4 * p * (p + 2)
        assert ops_seen["rank1|bytes"] == (
            {"broadcast": (rows - 1) * p, "all-reduce": 1},
            (rows - 1) * p * 4 * (N + 1) + tail)
        rem = (rows - 1 - r * K) * p
        assert ops_seen["panel|bytes"] == (
            {"broadcast": r * p + rem, "all-reduce": 1},
            r * p * 4 * (K * N + K) + rem * 4 * (N + 1) + tail)
        for update in ("rank1", "panel"):
            assert AuditReport.from_json(out[update]).ok
        bad = AuditReport.from_json(out["planted"])
        (f,) = bad.errors
        assert "broadcast moves 512 bytes" in f.message
    ctx = AuditContext(schedule="serial", n=N)
    assert run_passes(analysis.Module(), ctx,
                      ("collective-payload-budget",)).ok


def test_roofline_on_the_cards_rates():
    t = analysis.roofline(flops=989e12, hbm_bytes=3.35e12 / 2,
                          wire_bytes_per_chip=0.0, chips=1)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(0.5)
    assert t["bottleneck"] == "compute_s" and t["step_s_lower_bound"] == \
        pytest.approx(1.0)
    assert analysis.ir.HW != janalysis.ir.HW       # no TPU rate in the port


def test_run_passes_labels_registry_and_export_pass():
    assert tuple(PASSES) == DEFAULT_PASS_IDS
    assert DEFAULT_PASS_IDS == janalysis.DEFAULT_PASS_IDS
    assert set(janalysis.PASSES) - set(PASSES) == {"exportable-custom-calls"}
    r = run_passes(analysis.Module(), AuditContext(label="lbl"),
                   ("no-dense-factorization",))
    assert r.passes_run == ["no-dense-factorization"] and r.contexts == ["lbl"]
    with pytest.raises(TypeError, match="recorded Module"):
        run_passes("HloModule m", AuditContext())


# =================================================================== audit

def test_default_grid_matches_jax():
    assert default_grid() == jaudit.default_grid()
    assert default_grid(n=48, panel_k=16) == \
        jaudit.default_grid(n=48, panel_k=16)


def _pair_plans(entry, mesh1):
    entry = dict(entry)
    entry.pop("grad", None)
    size = entry.pop("n")
    method = entry.pop("method")
    mesh = entry.get("schedule") == "mesh"
    if method == "chebyshev":
        entry.setdefault("degree", 8)
    if method == "slq":
        entry.setdefault("num_steps", 8)
    jp = jax_plan((size, size), method=method,
                  **({"mesh": mesh1} if mesh else {}), **entry)
    # the JAX plans default to f64 (x64 on), the port's to f32
    tp = repro_torch.plan(torch.zeros((size, size), dtype=torch.float64),
                          method=method,
                          **({"mesh": MESH1} if mesh else {"device": "cpu"}),
                          **entry)
    return jp, tp


def test_context_labels_match_jax(mesh1):
    for entry in default_grid():
        jp, tp = _pair_plans(entry, mesh1)
        for kind in ("forward", "backward"):
            want = jaudit.context_for(jp, kind=kind)
            got = context_for(tp, kind=kind)
            assert got.label == want.label, entry
            for f in ("method", "schedule", "update", "lookahead", "panel_k",
                      "fused", "precision", "n", "devices", "itemsize",
                      "matrix_free"):
                assert getattr(got, f) == getattr(want, f), (entry, f)


JAX_STAGES = ("engine.pivot", "engine.swap", "engine.update",
              "engine.fused_step", "engine.mesh_tail", "engine.broadcast",
              "engine.lookahead_factor")


@pytest.mark.parametrize("devices", [1, 2])
def test_stage_map_matches_jax_at_grid_geometries(devices):
    for entry in default_grid():
        if entry["method"] != "exact":
            continue
        if entry.get("schedule") != "mesh" and devices > 1:
            continue
        kw = dict(method="exact", schedule=entry["schedule"],
                  update=entry["update"], lookahead=entry.get("lookahead",
                                                              False),
                  panel_k=K, fused=entry.get("fused", False), n=N,
                  devices=devices)
        want = janalysis.expected_engine_stages(janalysis.AuditContext(**kw))
        got = expected_engine_stages(AuditContext(**kw))
        assert set(got) == set(JAX_STAGES) | {
            "engine.panel_factor", "engine.panel_apply",
            "engine.panel_swap_gather"}
        assert {s: got[s] for s in JAX_STAGES} == want, entry
        panel = entry["update"] == "panel"
        assert got["engine.panel_factor"] == got["engine.panel_apply"] == panel
        assert got["engine.panel_swap_gather"] == (panel and kw["fused"])


def test_stage_map_documented_differences():
    """Where the maps part (the docstring of `expected_engine_stages`):
    one panel or one step in all has nothing to pipeline, and a panel
    route without a rank-1 step has no pivot."""
    one_panel = dict(method="exact", schedule="mesh", update="panel",
                     lookahead=True, panel_k=8, n=16, devices=1)
    assert janalysis.expected_engine_stages(janalysis.AuditContext(
        **one_panel))["engine.lookahead_factor"]
    assert not expected_engine_stages(AuditContext(
        **one_panel))["engine.lookahead_factor"]
    no_rank1 = dict(method="exact", schedule="serial", update="panel",
                    panel_k=8, n=9)
    assert janalysis.expected_engine_stages(janalysis.AuditContext(
        **no_rank1))["engine.pivot"]
    got = expected_engine_stages(AuditContext(**no_rank1))
    assert not got["engine.pivot"] and got["engine.panel_factor"]
    # ...and the recorded call agrees with the port's map
    p = repro_torch.plan((9, 9), method="exact", schedule="serial",
                         update="panel", k=8, device="cpu")
    assert p.audit(passes=["stage-coverage"]).ok


@pytest.mark.parametrize("ranks_", [1, 2])
def test_audit_grid_is_clean_with_the_jax_passes(ranks_):
    report = audit_grid(n=N, device="cpu", ranks=ranks_)
    assert report.ok and not report.findings, report.summary()
    assert report.passes_run == list(janalysis.DEFAULT_PASS_IDS)
    want = []
    for e in jaudit.default_grid(n=N):
        jp, _ = _pair_plans(e, None) if e.get("schedule") != "mesh" \
            else (None, None)
        if jp is None:
            continue
        want.append(jaudit.context_for(jp).label)
        if e.get("grad"):
            want.append(jaudit.backward_label(jp))
    assert report.contexts[:len(want)] == want
    assert report.contexts[len(want):] == [
        "exact:mesh/rank1", "exact:mesh/rank1/la", "exact:mesh/panel",
        "exact:mesh/panel/la"]
    assert report.meta["ranks"] == ranks_


def test_audit_grid_on_the_callers_mesh():
    """Every rank of an existing mesh (P = 2) audits the whole grid on it,
    nothing spawned: clean, the mesh entries at P = 2."""
    texts = run_ranks(ranks.grid_on_mesh, 2, backend="gloo", device="cpu",
                      timeout=240, args=(N,))
    for text in texts:
        report = AuditReport.from_json(text)
        assert report.ok and not report.findings, report.summary()
        assert report.passes_run == list(DEFAULT_PASS_IDS)
        assert len(report.contexts) == 15 and "ranks" not in report.meta


def test_plan_audit_serial_exact_clean():
    before = obs.events()
    report = _plan(method="exact", schedule="serial", update="rank1").audit()
    assert report.ok and not report.findings, report.summary()
    assert report.passes_run == list(DEFAULT_PASS_IDS)
    assert report.contexts[0] == "exact:serial/rank1"
    off, traced = report.meta["recordings"]
    assert (off["obs"], traced["obs"]) == ("off", "trace")
    assert off["kernels"] == {"rank1_update": N - 1}
    assert off["host_reads"] == 0 and not off["scopes"]
    # the trace recording keeps the scopes alone
    assert traced["ops"] == 0 and not traced["kernels"]
    assert traced["scopes"] == ["engine.pivot", "engine.swap",
                                "engine.update", "kernel.rank1_update",
                                "plan.execute"]
    # the trace recording leaves the caller's mode and trace buffer alone
    assert obs.mode() == "off" and obs.events() == before


def test_plan_audit_estimator_with_grad_is_matrix_free():
    for method, kw in (("chebyshev", dict(degree=8)),
                       ("slq", dict(num_steps=8))):
        p = _plan(method=method, num_probes=4, seed=0, **kw)
        report = p.audit(passes=["no-dense-factorization",
                                 "no-host-callback"], include_grad=True)
        assert report.ok and not report.findings, report.summary()
        assert report.contexts == [method, f"{method} backward"]


def test_plan_audit_pass_subset_respected():
    report = _plan(method="exact", schedule="serial").audit(
        passes=["no-host-callback"])
    assert report.passes_run == ["no-host-callback"]
    assert len(report.meta["recordings"]) == 1
    report = _plan(method="slq").audit(passes=["stage-coverage"])
    assert report.passes_run == ["stage-coverage"]
    assert not report.meta["recordings"]
    with pytest.raises(KeyError):
        _plan(method="exact").audit(passes=["exportable-custom-calls"])


def test_operator_and_sharded_plans_raise():
    from repro_torch.estimators import StencilOperator
    op = StencilOperator((0,), torch.full((1, N), 2.0))
    with pytest.raises(PlanAuditError, match="operator plans"):
        repro_torch.plan(op, method="slq", device="cpu").audit()
    with pytest.raises(PlanAuditError, match="no single program"):
        repro_torch.plan((N, N), method="slq", mesh=MESH1).audit()


def test_artifact_audit_round_trip(tmp_path):
    p = _plan(method="exact", schedule="serial")
    path = p.export(str(tmp_path / "serial.repro-torch-plan"))
    report = audit_artifact(path, device="cpu")
    assert report.ok and not report.findings, report.summary()
    assert report.contexts == [f"aot:exact:n{N}"]
    assert "stage-coverage" not in report.passes_run
    assert "exportable-custom-calls" not in report.passes_run
    dir_report = audit_aot_dir(tmp_path, device="cpu")
    assert dir_report.meta["artifacts"] == 1 and dir_report.ok
    # a fingerprint mismatch is a warning, not an exception
    raw = pathlib.Path(path).read_bytes()
    header = json.loads(raw[19:19 + int.from_bytes(raw[15:19], "little")])
    header["fingerprint"]["torch_version"] = "0.0"
    head = json.dumps(header).encode()
    (tmp_path / "other.repro-torch-plan").write_bytes(
        raw[:15] + len(head).to_bytes(4, "little") + head)
    mixed = audit_aot_dir(tmp_path, device="cpu")
    assert mixed.ok and mixed.meta["artifacts"] == 2
    assert [f.pass_id for f in mixed.warnings] == ["aot-fingerprint"]


def test_aot_dir_audit_warns_when_empty(tmp_path):
    report = audit_aot_dir(tmp_path, device="cpu")
    assert report.ok
    assert any(f.pass_id == "aot-scan" for f in report.warnings)


# ===================================================================== CLI

def _cli(argv):
    from repro_torch.analysis.__main__ import main
    return main(argv)


def test_cli_lint_exit_codes(tmp_path, capsys):
    bad = tmp_path / "mod.py"
    bad.write_text("import torch\nx = torch.zeros((4,))\n")
    assert _cli(["--lint", "--src", str(tmp_path)]) == 1
    assert "implicit-dtype" in capsys.readouterr().out
    waiver = tmp_path / "allow.toml"
    waiver.write_text('[[implicit-dtype]]\nwhere = "*mod.py:*"\n'
                      'reason = "test fixture"\n')
    assert _cli(["--lint", "--src", str(tmp_path),
                 "--allowlist", str(waiver)]) == 0
    assert _cli(["--lint", "--src", str(tmp_path), "--no-allowlist",
                 "--allowlist", str(waiver)]) == 1
    bad.write_text("x = 1\n")
    assert _cli(["--lint", "--src", str(tmp_path)]) == 0


def test_cli_json_strict_and_aot(tmp_path, capsys):
    (tmp_path / "clean.py").write_text("x = 1\n")
    out = tmp_path / "report.json"
    assert _cli(["--lint", "--src", str(tmp_path), "--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["passes_run"] == \
        list(analysis.LINT_RULES)
    empty = tmp_path / "plans"
    empty.mkdir()
    assert _cli(["--aot", str(empty), "--device", "cpu"]) == 0
    assert _cli(["--aot", str(empty), "--device", "cpu", "--strict"]) == 1
    capsys.readouterr()
    assert _cli(["--lint", "--src", str(tmp_path), "--json", "-"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


@pytest.mark.parametrize("passes", ["nope", "exportable-custom-calls"])
def test_cli_rejects_unknown_pass(tmp_path, passes):
    with pytest.raises(SystemExit):
        _cli(["--lint", "--src", str(tmp_path), "--passes", passes])


def test_cli_requires_a_mode():
    with pytest.raises(SystemExit):
        _cli([])


def test_cli_grid_on_the_cpu(capsys):
    assert _cli(["--grid", "--n", "24", "--device", "cpu",
                 "--passes", "no-host-callback,dtype-discipline"]) == 0
    assert "clean" in capsys.readouterr().out
