"""The port's observability (`repro_torch.obs`) and ``LogdetPlan.explain``,
on the CPU, against the JAX package's (`repro.obs`).

- **Names.**  On the same routes (staged rank1, panel, fused rank1 and
  panel; chebyshev, slq, cg; the estimator backward; the four exact mesh
  routes on one gloo rank) the port records the JAX package's stage and
  metric names.  The JAX package records a kernel stage only where its
  kernel backend runs one: the ``xla`` backend (its default on the CPU)
  runs ``engine.panel_factor`` inline and the ``interpret`` backend runs
  ``kernel.panel_factor_vmem`` instead, and both run the panel route's
  rank-1 steps and every mesh update inline.  The port runs every such
  step through its kernel (ROADMAP Queue 3, deliberate differences), so
  its set is the union of the two backends' sets plus, under each
  ``engine.update`` / ``engine.panel_apply`` / ``engine.panel_factor``,
  that step's kernel stage.  ``plan.traces``, ``plan.retraces`` and
  ``plan.compile`` count jit traces and have no eager meaning.
- **Numbers.**  The convergence curves (``chebyshev.sem``, ``slq.sem``,
  ``cg.resnorm``) equal the JAX package's in length and agree within
  1e-10 (relative to the curve's largest finite value) on shared probes.
- **Artifacts.**  The port's Chrome trace passes the JAX package's
  validator; the atexit artifacts carry the port's own file names.
- **Modes.**  ``off`` records nothing (and a `torch.profiler` run of a
  plan shows no ``engine.*`` / ``kernel.*`` range), results are bitwise
  equal across off, metrics and trace, and an unknown mode is an error.
- **explain.**  Its spec, config, precision and tiles lines equal the JAX
  package's for the same plan (tiles pinned by ``REPRO_AUTOTUNE`` in both;
  an exact config's ``backend=`` is "auto" in the port, where the JAX
  package prints the kernel backend it resolved).

Matrix sides (67, 71, 73, 79, 83) are used by no other test: the JAX
package stages its telemetry at trace time, so a jit cache filled with
obs off elsewhere in the process must not serve these calls.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro import obs as jobs
from repro.core.plan import clear_plan_cache as jax_clear_plan_cache
from repro.estimators import cg_solve as jax_cg_solve

import test_torch_ranks as ranks
from _subproc import SRC

import repro_torch
from repro_torch import obs
from repro_torch.core.mesh import run_ranks
from repro_torch.core.plan import clear_plan_cache
from repro_torch.estimators import cg_solve

EAGER_ONLY = {"plan.traces", "plan.retraces", "plan.compile"}
# the kernel stage under each engine stage whose work the port always
# sends through its kernel
KERNEL_UNDER = {"engine.update": "kernel.rank1_update",
                "engine.panel_apply": "kernel.panel_update",
                "engine.panel_factor": "kernel.panel_factor_vmem"}
K = 8
N_EXACT, N_CHEB, N_SLQ, N_CG, N_MESH = 67, 71, 73, 79, 83
CURVE_RTOL = 1e-10
SPAWN_TIMEOUT = 300

EXACT_ROUTES = {
    "rank1": dict(update="rank1"),
    "panel": dict(update="panel", k=K),
    "fused": dict(update="rank1", fused=True),
    "fused_panel": dict(update="panel", k=K, fused=True),
}


@pytest.fixture(autouse=True)
def obs_state():
    """Both packages' obs off and empty around every test."""
    for o in (obs, jobs):
        o.reset()
        o.configure("off")
    yield
    for o in (obs, jobs):
        o.reset()
        o.configure("off")


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n))
    return x @ x.T / n + 2.0 * np.eye(n)


def _names(o, fn):
    """(stage names, metric names) that ``fn`` records under obs ``o`` in
    trace mode."""
    o.reset()
    o.configure("trace")
    try:
        fn()
        o.flush_telemetry()
        stages = {e["name"] for e in o.events()}
        metrics = {key.split("{")[0] for group in o.snapshot().values()
                   for key in group}
    finally:
        o.configure("off")
        o.reset()
    return stages - EAGER_ONLY, metrics - EAGER_ONLY


def _expected(*name_sets):
    stages = set().union(*(s for s, _ in name_sets))
    metrics = set().union(*(m for _, m in name_sets))
    extra = {KERNEL_UNDER[s] for s in stages if s in KERNEL_UNDER}
    if extra:
        metrics.add("kernel.dispatch")
    return stages | extra, metrics


def _jax_exact(a, kw, backend, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", backend)
    jax_clear_plan_cache()
    try:
        return _names(jobs, lambda: repro.plan(a, method="exact",
                                               schedule="staged", **kw)())
    finally:
        monkeypatch.delenv("REPRO_KERNEL_BACKEND")


@pytest.mark.parametrize("route", list(EXACT_ROUTES))
def test_exact_route_names_match_jax(route, monkeypatch):
    a = _spd(N_EXACT)
    kw = EXACT_ROUTES[route]
    want = _expected(_jax_exact(a, kw, "xla", monkeypatch),
                     _jax_exact(a, kw, "interpret", monkeypatch))
    clear_plan_cache()
    got = _names(obs, lambda: repro_torch.plan(
        torch.from_numpy(a), method="exact", schedule="staged",
        device="cpu", **kw)())
    assert got == want


def _estimator_calls(method):
    """(jax call, port call) of one estimator route on shared inputs."""
    n = {"chebyshev": N_CHEB, "slq": N_SLQ, "cg": N_CG,
         "grad": N_SLQ}[method]
    a = _spd(n, seed=3)
    probes = np.random.default_rng(4).choice([-1.0, 1.0], size=(n, 8))
    at = torch.from_numpy(a)
    if method == "cg":
        b = np.random.default_rng(5).standard_normal((n, 3))
        return (lambda: jax_cg_solve(a, b, tol=1e-8),
                lambda: cg_solve(at, torch.from_numpy(b), tol=1e-8,
                                 device="cpu"))
    if method == "grad":
        return (lambda: repro.plan(a, method="slq", num_steps=12,
                                   num_probes=8).value_and_grad(),
                lambda: repro_torch.plan(at, method="slq", num_steps=12,
                                         num_probes=8, device="cpu")
                .value_and_grad())
    kw = dict(degree=32) if method == "chebyshev" else dict(num_steps=12)
    bounds = {}
    if method == "chebyshev":
        ev = np.linalg.eigvalsh(a)
        bounds = dict(lmin=0.9 * ev[0], lmax=1.1 * ev[-1])
    return (lambda: repro.plan(a, method=method, num_probes=8, **kw)(
                probes=probes, **bounds),
            lambda: repro_torch.plan(at, method=method, num_probes=8,
                                     device="cpu", **kw)(
                probes=torch.from_numpy(probes), **bounds))


@pytest.mark.parametrize("method", ["chebyshev", "slq", "cg", "grad"])
def test_estimator_route_names_match_jax(method):
    jax_call, port_call = _estimator_calls(method)
    jax_clear_plan_cache()
    clear_plan_cache()
    want = _expected(_names(jobs, jax_call))
    assert _names(obs, port_call) == want


def _jax_mesh_names(a, mesh1):
    out = {}
    for update in ("rank1", "panel"):
        for la in (False, True):
            jax_clear_plan_cache()
            out[f"{update}|{la}"] = _names(jobs, lambda: repro.plan(
                a, method="exact", mesh=mesh1, update=update, k=K,
                lookahead=la)())
    return out


def test_mesh_route_names_match_jax_and_results_are_bitwise(mesh1):
    """One gloo rank (a spawned process) against the JAX package's
    one-device mesh: the names, and each route's result equal under obs
    off, metrics and trace."""
    a = _spd(N_MESH, seed=6)
    [port] = run_ranks(ranks.obs_mesh_names, 1, backend="gloo",
                       device="cpu", timeout=SPAWN_TIMEOUT, args=(a, K))
    for route, names in _jax_mesh_names(a, mesh1).items():
        stages, metrics = port[route]
        assert (set(stages), set(metrics)) == _expected(names), route
        results = {port[f"{route}|{m}"] for m in ("off", "metrics", "trace")}
        assert len(results) == 1, (route, results)


@pytest.mark.parametrize("method", ["chebyshev", "slq", "cg"])
def test_telemetry_curves_match_jax(method):
    jax_call, port_call = _estimator_calls(method)
    jax_clear_plan_cache()
    clear_plan_cache()
    curves = []
    for o, call in ((jobs, jax_call), (obs, port_call)):
        o.configure("trace")
        o.drain_telemetry()
        out = call()
        o.flush_telemetry()
        conv = out.diagnostics.convergence if method != "cg" \
            else o.drain_telemetry()
        o.configure("off")
        curves.append(conv)
    want, got = curves
    name = f"{method}.sem" if method != "cg" else "cg.resnorm"
    assert set(got) == set(want) == {name}
    w, g = np.asarray(want[name]), np.asarray(got[name])
    assert len(g) == len(w) > 1
    scale = np.abs(w[np.isfinite(w)]).max()
    np.testing.assert_allclose(g, w, rtol=0, atol=CURVE_RTOL * scale)


def test_running_sem_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 17))
    np.testing.assert_allclose(
        obs.running_sem(torch.from_numpy(x)).numpy(),
        np.asarray(jobs.running_sem(x)), rtol=1e-12)


def test_chrome_trace_passes_the_jax_validator(tmp_path):
    obs.configure("trace")
    repro_torch.plan(torch.from_numpy(_spd(N_EXACT)), method="exact",
                     update="panel", k=K, device="cpu")()
    path = obs.export_chrome_trace(str(tmp_path / "t.json"))
    summary = jobs.validate_chrome_trace(path)
    assert {"plan.execute", "engine.panel_factor",
            "kernel.panel_update"} <= set(summary["names"])
    assert summary["max_depth"] >= 2        # plan > engine > kernel
    from repro_torch.obs.__main__ import main
    assert main(["validate", path, "--require", "engine.panel_apply",
                 "--require-prefix", "kernel."]) == 0
    assert main(["validate", path, "--require", "engine.mesh_tail"]) == 1


def _profiled_range_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("route", ["rank1", "panel", "fused"])
def test_off_records_nothing_and_results_are_bitwise(route):
    """Under off: no span, no metric, no telemetry, and a profiled plan
    call shows no engine or kernel range; under trace it shows them.  The
    result is bitwise the same in the three modes."""
    a = torch.from_numpy(_spd(N_EXACT))
    p = repro_torch.plan(a, method="exact", device="cpu",
                         **EXACT_ROUTES[route])
    results = {}
    for mode in ("off", "metrics", "trace"):
        obs.reset()
        obs.configure(mode)
        names = _profiled_range_names(lambda: results.setdefault(mode, p()))
        staged = {n for n in names if n.startswith(("engine.", "kernel."))}
        if mode == "off":
            assert obs.events() == [] and staged == set()
            assert obs.snapshot() == {"counters": {}, "gauges": {},
                                      "histograms": {}}
        elif mode == "trace":
            assert "engine.swap" in staged or "engine.fused_step" in staged
            assert staged == {e["name"] for e in obs.events()
                              if e["name"].startswith(("engine.",
                                                       "kernel."))}
        else:
            assert obs.events() == [] and staged == set()
            assert obs.counter_value("plan.executions", method="exact") == 1
    for mode in ("metrics", "trace"):
        assert torch.equal(results[mode].sign, results["off"].sign)
        assert torch.equal(results[mode].logabsdet, results["off"].logabsdet)


def test_estimator_results_are_bitwise_across_modes():
    a = torch.from_numpy(_spd(N_SLQ, seed=3))
    p = repro_torch.plan(a, method="slq", num_steps=12, num_probes=8,
                         device="cpu")
    out = []
    for mode in ("off", "metrics", "trace"):
        obs.configure(mode)
        res = p(generator=torch.Generator().manual_seed(3))
        out.append((res.logabsdet, res.sem, res.diagnostics.convergence))
    assert all(torch.equal(o[0], out[0][0]) and torch.equal(o[1], out[0][1])
               for o in out)
    assert out[0][2] is None and out[1][2] is None
    assert len(out[2][2]["slq.sem"]) == 8


def test_stage_off_is_one_shared_noop():
    assert obs.stage("engine.pivot") is obs.stage("kernel.matvec", backend="x")
    assert obs.span("plan.build") is obs.stage("engine.swap")
    obs.configure("metrics")
    assert obs.stage("engine.pivot") is obs.stage("engine.swap")
    with obs.span("plan.execute", sync="cpu"):     # syncs in every mode
        pass
    assert obs.events() == []


def test_metrics_mode_counters():
    obs.configure("metrics")
    a = torch.from_numpy(_spd(N_EXACT))
    clear_plan_cache()
    for _ in range(2):
        repro_torch.plan(a, method="exact", update="panel", k=K,
                         device="cpu")()
    assert obs.counter_value("plan.cache.misses") == 1
    assert obs.counter_value("plan.cache.hits") == 1
    assert obs.counter_value("plan.executions", method="exact") == 2
    assert obs.counter_value("kernel.dispatch", op="panel_update",
                             backend="torch") > 0
    text = obs.prometheus_text()
    assert "repro_torch_kernel_dispatch_total{backend=\"torch\"" in text
    assert "repro_torch_plan_flops_est" in text


def test_unknown_mode_is_a_hard_error():
    with pytest.raises(ValueError, match="choose one of"):
        obs.configure("verbose")
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_OBS="bogus")
    proc = subprocess.run([sys.executable, "-c", "import repro_torch"],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "REPRO_OBS='bogus'" in proc.stderr


def test_env_var_writes_the_port_artifacts(tmp_path):
    """``REPRO_OBS=trace`` in the environment: the atexit hook writes the
    port's own three files, never the JAX package's names."""
    code = ("import torch, repro_torch\n"
            "a = torch.eye(9, dtype=torch.float64) * 2\n"
            "repro_torch.plan(a, method='exact', device='cpu')()\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_OBS="trace",
               REPRO_OBS_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(tmp_path)) == sorted(obs.ARTIFACTS.values())
    assert not set(obs.ARTIFACTS.values()) & {"trace.json", "events.jsonl",
                                               "metrics.prom"}
    summary = jobs.validate_chrome_trace(
        str(tmp_path / obs.ARTIFACTS["trace"]))
    assert "engine.pivot" in summary["names"]
    lines = (tmp_path / obs.ARTIFACTS["events"]).read_text().splitlines()
    assert all(json.loads(line)["kind"] for line in lines)


EXPLAIN_PLANS = {
    "exact_panel": dict(method="exact", update="panel", k=K),
    "exact_bf16": dict(method="exact", update="rank1", precision="bf16"),
    "slq": dict(method="slq", num_steps=12, num_probes=8),
    "chebyshev": dict(method="chebyshev", degree=16, num_probes=8),
}


@pytest.mark.parametrize("name", list(EXPLAIN_PLANS))
def test_explain_matches_jax(name, monkeypatch, tmp_path):
    """spec, config, precision and tiles lines equal the JAX package's;
    the execution line reads eager and the device; no traces line."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "panel_k=16,block_m=64,block_n=128")
    a = _spd(N_EXACT)
    kw = EXPLAIN_PLANS[name]
    want = repro.plan(a, **kw).explain().splitlines()
    got = repro_torch.plan(torch.from_numpy(a), device="cpu",
                           **kw).explain().splitlines()
    n_fixed = 5 if kw["method"] == "exact" else 3
    # the JAX package resolves an exact config's backend to its kernel
    # backend ("xla" on the CPU); the port's is always "auto" (the kernel
    # follows the tensor's device)
    want = [l.replace("backend='xla'", "backend='auto'") for l in want]
    assert got[:n_fixed] == want[:n_fixed]
    execution = [l for l in got if l.startswith("  execution:")]
    assert execution and "eager on cpu" in execution[0]
    assert not any(l.startswith("  traces:") for l in got)
    assert got[-1] == want[-1]                   # the obs-off line
    # audit is ported (tests/test_torch_analysis.py): a report of the
    # plan's recorded call, labelled as the JAX package labels it
    report = repro_torch.plan(torch.from_numpy(a), device="cpu",
                              **kw).audit()
    assert report.ok, report.summary()
    assert report.meta["plans"][0].startswith(kw["method"])
    # export is ported (tests/test_torch_serve.py): the artifact names the
    # plan's method
    from repro_torch.serve.aot import read_header
    path = repro_torch.plan(torch.from_numpy(a), device="cpu",
                            **kw).export(str(tmp_path / "p.plan"))
    assert read_header(path)["method"] == kw["method"]


def test_explain_reports_convergence_and_obs_state():
    obs.configure("trace")
    p = repro_torch.plan(torch.from_numpy(_spd(N_SLQ, seed=3)), method="slq",
                         num_steps=12, num_probes=8, device="cpu")
    assert "none recorded yet" in p.explain()
    p(generator=torch.Generator().manual_seed(0))
    text = p.explain()
    assert "slq.sem: 8 points" in text and "obs[trace]: plan cache" in text


def test_top_level_exports_cover_jax():
    """The port's ``__all__`` holds the JAX package's names, ``load_plan``
    included since serving was ported, and each is the port's own
    object."""
    missing = set(repro.__all__) - set(repro_torch.__all__)
    assert missing == set()
    for name in repro_torch.__all__:
        obj = getattr(repro_torch, name)
        home = getattr(obj, "__module__", None) or obj.__name__
        assert home.startswith("repro_torch"), (name, home)
