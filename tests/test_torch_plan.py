"""`repro_torch.plan` (exact family) against `repro.plan` on the same numpy
inputs, the config hand-over from the JAX package, the rejected knobs,
the device rule (the card unless the caller asks for the CPU), and a
static check that the port never imports JAX or the JAX package.

Tolerances: sign exact; log|det| rtol 1e-10 in f64 and 1e-4 in f32 (FMA
contraction, triangular solve and GEMM summation order differ between
the frameworks), 5e-3 with bf16 operands (the documented bf16 error
model; the JAX reference runs its ``xla`` backend there, because its
interpret-mode kernel cannot run a bf16 dot inside the engine under jax
0.9 on the CPU).
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro
from repro.core.configs import config_to_dict as jax_config_to_dict

import repro_torch
from repro_torch.core import (ExactConfig, LogdetResult, clear_plan_cache,
                              config_from_dict, config_to_dict,
                              from_jax_config, pad_to_multiple)
from repro_torch.analysis import DEFAULT_PASS_IDS
from repro_torch.core.engine import LEGACY_ROUTES
from repro_torch.core.mesh import Mesh
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
# the module (repro_torch.core re-exports the function under its name)
plan_mod = importlib.import_module("repro_torch.core.plan")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These matrices are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROUTES = [
    {},
    {"fused": True},
    {"update": "panel", "k": 8, "min_size": 16},
    {"update": "panel", "k": 8, "min_size": 16, "fused": True},
    {"schedule": "serial"},
    {"schedule": "serial", "update": "panel", "k": 16},
]


def _matrix(n=50, seed=3, neg_row=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    a = x @ x.T / (2 * n) + 2.0 * np.eye(n)
    if neg_row:
        a[4] = -a[4]
    return a


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10),
                                        ("float32", 1e-4)])
@pytest.mark.parametrize("kw", ROUTES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_plan_matches_jax_plan(kw, dtype, rtol):
    a = _matrix().astype(dtype)
    jres = repro.plan(a, method="exact", backend="interpret", **kw)()
    res = repro_torch.plan(a, method="exact", device="cpu", **kw)()
    assert isinstance(res, LogdetResult)
    assert res.sign.dtype == getattr(torch, dtype)
    assert float(res.sign) == float(jres.sign) == -1.0
    np.testing.assert_allclose(float(res.logabsdet), float(jres.logabsdet),
                               rtol=rtol)
    assert float(res.sem) == 0.0 and res.method_used == "exact"
    assert res.diagnostics.padded_n == jres.diagnostics.padded_n
    assert res.diagnostics.wall_time_s is not None


@pytest.mark.parametrize("fused", [False, True])
def test_plan_bf16_matches_jax_plan(fused):
    a = _matrix().astype(np.float32)
    kw = dict(update="panel", k=8, min_size=16, fused=fused)
    jres = repro.plan(a, method="exact", backend="xla", precision="bf16",
                      **kw)()
    res = repro_torch.plan(a, method="exact", device="cpu",
                           precision="bf16", **kw)()
    assert res.logabsdet.dtype == torch.float32
    assert res.sign.item() == float(jres.sign)
    ld_ref = float(jres.logabsdet)
    assert abs(res.logabsdet.item() - ld_ref) <= 5e-3 * abs(ld_ref)


@pytest.mark.parametrize("kw", ROUTES[1:4] + [{"precision": "bf16",
                                               "update": "panel", "k": 8}])
def test_from_jax_config_builds_the_same_route(kw):
    a = _matrix(n=40)
    backend = "xla" if "precision" in kw else "interpret"
    jplan = repro.plan(a, method="exact", backend=backend, **kw)
    cfg = from_jax_config(jax_config_to_dict(jplan.config))
    p = repro_torch.plan(a, method="exact", device="cpu", config=cfg)
    for f in ("k", "schedule", "update", "shrink", "min_size", "fused",
              "precision", "lookahead"):
        assert getattr(p.config, f) == getattr(jplan.config, f), f
    assert p.config.backend == "auto"
    s, ld = p()
    js, jld = jplan()
    rtol = 5e-3 if "precision" in kw else 1e-10
    assert float(s) == float(js)
    np.testing.assert_allclose(float(ld), float(jld), rtol=rtol)


def test_from_jax_config_rejects_what_is_not_ported():
    # the mesh schedule and lookahead are ported: they cross as they are
    for kw in ({"schedule": "mesh"}, {"lookahead": True},
               {"schedule": "mesh", "lookahead": True, "update": "panel"}):
        cfg = from_jax_config(jax_config_to_dict(
            repro.core.configs.ExactConfig(**kw)))
        assert all(getattr(cfg, f) == v for f, v in kw.items())
        assert cfg.resolved(mesh_present=True).schedule == "mesh"
    with pytest.raises(ValueError, match="KroneckerConfig"):
        from_jax_config({"type": "KroneckerConfig"})


def test_config_dict_round_trip_and_shape():
    cfg = ExactConfig(k=16, update="panel", fused=True, precision="bf16")
    d = config_to_dict(cfg)
    assert config_from_dict(d) == cfg
    jd = jax_config_to_dict(repro.core.configs.ExactConfig())
    assert set(d) == set(jd)
    with pytest.raises(ValueError, match="unknown fields"):
        config_from_dict({**d, "warp": 1})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_pad_to_multiple_keeps_dtype(dtype):
    a = torch.from_numpy(_matrix(n=10)).to(dtype)
    p = pad_to_multiple(a, 8)
    assert p.dtype == dtype and p.shape == (16, 16)
    assert torch.equal(p[:10, :10], a)
    assert torch.equal(p[10:, 10:], torch.eye(6, dtype=dtype))
    assert not p[:10, 10:].any() and not p[10:, :10].any()
    assert pad_to_multiple(a, 5) is a
    jp = np.asarray(repro.core.pad_to_multiple(
        jnp.asarray(a.double().numpy()), 8))
    np.testing.assert_array_equal(p.double().numpy(), jp)


@pytest.mark.parametrize("method", ["mc", "mc_staged", "mc_blocked", "pmc",
                                    "pmc_blocked"])
def test_unported_methods_name_their_roadmap_item(method):
    """The legacy route strings (ROADMAP Queue 1 item 12) are ported: each
    plans ``method="exact"`` with the schedule and update it pins, under
    a DeprecationWarning naming them (tests/test_torch_api.py holds their
    results)."""
    schedule, update = LEGACY_ROUTES[method]
    kw = {}
    if schedule == "mesh":
        kw["mesh"] = Mesh(group=None, size=1, rank=0,
                          device=torch.device("cpu"))
    with pytest.warns(DeprecationWarning,
                      match=f"schedule={schedule!r}, update={update!r}"):
        p = repro_torch.plan(_matrix(), method=method, device="cpu", **kw)
    assert p.method == "exact"
    assert (p.config.schedule, p.config.update) == (schedule, update)


@pytest.mark.parametrize("kw,exc", [
    ({"mesh": object()}, TypeError),
    ({"grad_cg_tol": 1e-6}, TypeError),
    ({"schedule": "mesh"}, ValueError),
    ({"lookahead": True}, ValueError),
    ({"backend": "xla"}, ValueError),
    ({"backend": "interpret"}, ValueError),
    ({"num_probes": 4}, TypeError),
    ({"warp": 2}, TypeError),
    ({"precision": "fp8"}, TypeError),
    ({"config": ExactConfig(), "k": 8}, TypeError),
    ({"shrink": 1.5}, ValueError),
])
def test_rejected_knobs_raise(kw, exc):
    with pytest.raises(exc):
        repro_torch.plan(_matrix(), method="exact", device="cpu", **kw)


@pytest.mark.parametrize("x,kw", [
    ("dense", {"fused": True}),
    ("dense", {"fused": True, "update": "panel"}),
    ("dense", {"lookahead": True, "mesh": None}),
    ("batched", {}),
])
def test_mesh_rejections_match_jax(mesh1, x, kw):
    """fused with a mesh and lookahead without one raise ValueError, a
    batched stack with a mesh TypeError, in both packages."""
    kw = dict(kw)
    with_mesh = kw.pop("mesh", True)
    inputs = {"dense": _matrix(), "batched": (2, 8, 8)}
    with pytest.raises((TypeError, ValueError)) as jax_err:
        repro.plan(inputs[x], method="exact",
                   mesh=mesh1 if with_mesh else None, **kw)
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(jax_err.type):
        repro_torch.plan(inputs[x], method="exact", device="cpu",
                         mesh=mesh if with_mesh else None, **kw)


def test_rejected_inputs_raise():
    # a stack runs the exact routes of one device; pge spans a mesh
    with pytest.raises(TypeError, match="ONE matrix"):
        repro_torch.plan((2, 8, 8), method="pge", device="cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        repro_torch.plan(np.eye(4, dtype=np.int32), method="exact",
                         device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        repro_torch.plan(_matrix(), method="qr", device="cpu")
    with pytest.raises(ValueError, match="square"):
        repro_torch.plan((3, 4), method="exact", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        ExactConfig(precision="fp8")


def test_unported_plan_methods_raise():
    """audit (ROADMAP Queue 1 item 11) and the legacy route strings (item
    12) are ported and raise no more: ``audit`` returns a clean report of
    the default passes (tests/test_torch_analysis.py holds it against the
    JAX package), ``method="mc"`` plans serial x rank1; export is ported
    too (tests/test_torch_serve.py)."""
    p = repro_torch.plan(_matrix(), method="exact", device="cpu")
    report = p.audit()
    assert report.ok, report.summary()
    assert report.passes_run == list(DEFAULT_PASS_IDS)
    with pytest.warns(DeprecationWarning, match="'mc' is deprecated"):
        q = repro_torch.plan(_matrix(), method="mc", device="cpu")
    assert (q.config.schedule, q.config.update) == ("serial", "rank1")


def test_explain_describes_the_plan():
    """``explain`` is ported (tests/test_torch_obs.py holds its lines
    against the JAX package's): the method, spec and eager execution."""
    p = repro_torch.plan(_matrix(), method="exact", device="cpu")
    text = p.explain()
    assert text.startswith("LogdetPlan[exact]")
    assert "execution: eager on cpu" in text and "traces:" not in text


def test_no_card_and_no_device_raises(monkeypatch):
    """device=None means the card: without one, plan() raises and names
    the CPU opt-in; it never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(plan_mod, "_build_forward",
                        lambda *a, **k: ran.append(1))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        repro_torch.plan(_matrix(), method="exact")
    assert not ran


def test_plan_cache_keys_on_device_and_config():
    clear_plan_cache()
    a = _matrix()
    p1 = repro_torch.plan(a, method="exact", device="cpu", update="panel")
    p2 = repro_torch.plan(a, method="exact", device="cpu", update="panel")
    assert p1._fwd is p2._fwd
    p3 = repro_torch.plan(a, method="exact", device="cpu", update="rank1")
    assert p3._fwd is not p1._fwd
    assert len(plan_mod._PLAN_CACHE) == 2


def test_plan_from_a_shape_and_input_checks():
    a = _matrix()
    p = repro_torch.plan(a.shape, method="exact", device="cpu",
                         precision="float64")
    with pytest.raises(TypeError, match="shape spec"):
        p()
    with pytest.raises(ValueError, match="shape"):
        p(np.eye(3))
    s, ld = p(a)
    s2, ld2 = p.slogdet(a)
    assert torch.equal(s, s2) and torch.equal(ld, ld2)
    assert torch.equal(p.logdet(a), ld)
    s_np, ld_np = np.linalg.slogdet(a)
    assert float(s) == s_np
    np.testing.assert_allclose(float(ld), ld_np, rtol=1e-10)


@pytest.mark.parametrize("update", ["rank1", "panel"])
def test_plan_never_modifies_the_callers_tensor(update):
    a = torch.from_numpy(_matrix(n=40))
    before = a.clone()
    for fused in (False, True):
        repro_torch.plan(a, method="exact", device="cpu", update=update,
                         k=8, fused=fused)()
    assert torch.equal(a, before)


def test_launch_counts_stay_zero_on_the_cpu():
    ops.reset_launch_counts()
    repro_torch.plan(_matrix(), method="exact", device="cpu",
                     update="panel", k=8)()
    assert set(ops.launch_counts().values()) == {0}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_calibrate.py",
              ROOT / "tools" / "obs_cost.py",
              ROOT / "tools" / "serve_smoke_torch.py",
              ROOT / "tools" / "models_probe.py",
              ROOT / "tools" / "train_probe.py",
              ROOT / "tools" / "launch_timing.py",
              ROOT / "examples" / "quickstart_torch.py",
              ROOT / "examples" / "gmm_fit_torch.py",
              ROOT / "examples" / "gmm_loglik_torch.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_public_surface():
    for name in ("plan", "LogdetPlan", "ExactConfig", "EngineConfig",
                 "LogdetResult"):
        assert hasattr(repro_torch, name)
    assert dataclasses.is_dataclass(repro_torch.ExactConfig)


def test_import_check_covers_the_estimators():
    """The static check above walks src/repro_torch recursively, so the
    estimator modules, operators included, are among the files it reads."""
    files = set((ROOT / "src" / "repro_torch").rglob("*.py"))
    est_dir = ROOT / "src" / "repro_torch" / "estimators"
    for name in ("chebyshev.py", "slq.py", "hutchinson.py", "grad.py",
                 "operators/solve.py", "operators/stencil.py"):
        assert est_dir / name in files
    assert "torch" in set(_imports(est_dir / "operators" / "stencil.py")) | {
        n.split(".")[0] for n in _imports(est_dir / "slq.py")}


# ------------------------------------------------------------ estimators

def _lattice_op(side=6, dt=np.float64):
    from repro_torch.estimators import StencilOperator
    from repro.estimators import StencilOperator as JStencil
    n = side * side
    i = np.arange(n)
    bands = np.full((5, n), -1.0)
    bands[2] = 4.1
    bands[1][i % side == 0] = 0.0
    bands[3][i % side == side - 1] = 0.0
    offsets = (-side, -1, 0, 1, side)
    bands = bands.astype(dt)
    return (StencilOperator(offsets, torch.from_numpy(bands)),
            JStencil(offsets, jnp.asarray(bands)))


EST_ROUTES = [("chebyshev", {"degree": 16, "num_probes": 8}),
              ("chebyshev", {"degree": 20, "num_probes": 8,
                             "probe_kind": "gaussian"}),
              ("slq", {"num_steps": 10, "num_probes": 8})]


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10),
                                        ("float32", 1e-4)])
@pytest.mark.parametrize("kind", ["dense", "stencil"])
@pytest.mark.parametrize("method,kw", EST_ROUTES,
                         ids=["cheb", "cheb_gauss", "slq"])
def test_estimator_plan_matches_jax_plan(method, kw, kind, dtype, rtol):
    if kind == "dense":
        x = jx = _matrix(n=36, neg_row=False).astype(dtype)
    else:
        x, jx = _lattice_op(dt=np.dtype(dtype).type)
    n = 36
    rng = np.random.default_rng(11)
    probes = (rng.standard_normal((n, 8)) if kw.get("probe_kind")
              else rng.choice([-1.0, 1.0], (n, 8))).astype(dtype)
    bounds = ({"lmin": 0.05, "lmax": 8.5} if method == "chebyshev" else {})
    jres = repro.plan(jx, method=method, **kw)(probes=jnp.asarray(probes),
                                               **bounds)
    res = repro_torch.plan(x, method=method, device="cpu", **kw)(
        probes=probes, **bounds)
    assert isinstance(res, LogdetResult) and res.method_used == method
    assert res.logabsdet.dtype == getattr(torch, dtype)
    assert float(res.sign) == float(jres.sign) == 1.0
    np.testing.assert_allclose(float(res.logabsdet), float(jres.logabsdet),
                               rtol=rtol)
    np.testing.assert_allclose(float(res.sem), float(jres.sem),
                               rtol=10 * rtol)


@pytest.mark.parametrize("method,kw", EST_ROUTES[::2], ids=["cheb", "slq"])
def test_estimator_diagnostics_match_jax(method, kw):
    for x, jx in ((_matrix(n=36, neg_row=False),) * 2, _lattice_op()):
        d = repro_torch.plan(x, method=method, device="cpu", **kw).diagnostics
        jd = repro.plan(jx, method=method, **kw).diagnostics
        assert d.matvec_cols == jd.matvec_cols
        assert d.flops_est == pytest.approx(jd.flops_est)
        assert d.padded_n == 36


@pytest.mark.parametrize("method,kw", EST_ROUTES[::2], ids=["cheb", "slq"])
def test_from_jax_config_estimators(method, kw):
    a = _matrix(n=30, neg_row=False)
    jplan = repro.plan(a, method=method, seed=3, **kw)
    d = jax_config_to_dict(jplan.config)
    cfg = from_jax_config(d)
    assert config_to_dict(cfg) == d
    assert config_from_dict(config_to_dict(cfg)) == cfg
    p = repro_torch.plan(a, method=method, device="cpu", config=cfg)
    assert p.config == cfg
    probes = np.random.default_rng(12).choice([-1.0, 1.0], (30, 8))
    bounds = {"lmin": 0.5, "lmax": 6.0} if method == "chebyshev" else {}
    np.testing.assert_allclose(
        float(p(probes=probes, **bounds).logabsdet),
        float(jplan(probes=jnp.asarray(probes), **bounds).logabsdet),
        rtol=1e-10)
    with pytest.raises(TypeError, match="needs a"):
        repro_torch.plan(a, method="exact", device="cpu", config=cfg)


def test_estimator_configs_validate():
    from repro_torch.core import ChebyshevConfig, SLQConfig
    with pytest.raises(ValueError, match="degree"):
        ChebyshevConfig(degree=0)
    with pytest.raises(ValueError, match="probe_kind"):
        ChebyshevConfig(probe_kind="sobol")
    with pytest.raises(ValueError, match="lmax > lmin"):
        ChebyshevConfig(lmin=2.0, lmax=1.0)
    with pytest.raises(TypeError, match="scalar"):
        ChebyshevConfig(lmin=np.ones(3))
    assert ChebyshevConfig(lmin=np.float32(0.5)).lmin == 0.5
    with pytest.raises(ValueError, match="num_steps"):
        SLQConfig(num_steps=0)
    with pytest.raises(TypeError, match="unknown keywords"):
        repro_torch.plan(_matrix(), method="slq", device="cpu", degree=3)


@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_validate_spd_like_rejects(method):
    a = _matrix(n=20, neg_row=False)
    bad = a.copy()
    bad[0, 1] += 1.0
    with pytest.raises(ValueError, match="not symmetric"):
        repro_torch.plan(bad, method=method, device="cpu")()
    neg = a.copy()
    neg[2, 2] = -1.0
    with pytest.raises(ValueError, match="positive-definite"):
        repro_torch.plan(neg, method=method, device="cpu")()
    res = repro_torch.plan(bad, method=method, device="cpu",
                           validate=False)()
    assert np.isfinite(float(res.logabsdet))


@pytest.mark.parametrize("x,kw,exc", [
    ("dense", {"method": "slq", "degree": 8}, TypeError),
    ("dense", {"method": "chebyshev", "mesh": object()}, TypeError),
    ("batched", {"method": "slq",
                 "mesh": Mesh(group=None, size=1, rank=0,
                              device=torch.device("cpu"))}, TypeError),
    ("stencil", {"method": "exact"}, TypeError),
    ("stencil", {"method": "slq", "precision": "float64"}, ValueError),
    ("dense", {"method": "chebyshev", "precision": "bf16"}, ValueError),
])
def test_estimator_plans_reject(x, kw, exc):
    inputs = {"dense": _matrix(n=12, neg_row=False), "batched": (2, 8, 8),
              "stencil": _lattice_op(side=3)[0]}
    with pytest.raises(exc):
        repro_torch.plan(inputs[x], device="cpu", **kw)


@pytest.mark.parametrize("name", ["KroneckerOperator", "ToeplitzOperator"])
def test_structured_backends_plan(name):
    """Ported: a plan on either operator takes an estimator (auto: slq),
    and its estimate lies within 5 sem of the dense log|det|."""
    from repro_torch import estimators
    if name == "KroneckerOperator":
        op = estimators.KroneckerOperator(
            torch.from_numpy(_matrix(n=4, neg_row=False)),
            torch.from_numpy(_matrix(n=3, neg_row=False)))
    else:
        op = estimators.ToeplitzOperator(
            torch.tensor([2.0, 0.6, 0.2, 0.05], dtype=torch.float64))
    p = repro_torch.plan(op, device="cpu", num_steps=10, num_probes=16)
    res = p(generator=torch.Generator().manual_seed(0))
    exact = torch.linalg.slogdet(op.to_dense())[1]
    assert p.method == "slq" and p.spec.kind == "operator"
    assert abs(float(res.logabsdet - exact)) <= 5 * float(res.sem) + 1e-10


def test_estimator_plan_rejects_runtime_inputs_on_exact():
    p = repro_torch.plan(_matrix(), method="exact", device="cpu")
    with pytest.raises(TypeError, match="no generator"):
        p(probes=np.ones((50, 2)))
    with pytest.raises(TypeError, match="no generator"):
        p.value_and_grad(generator=torch.Generator())


@pytest.mark.parametrize("method", ["chebyshev", "slq"])
def test_seed_repeats_and_generator_overrides(method):
    a = _matrix(n=24, neg_row=False)
    kw = dict(num_probes=4)
    r1 = repro_torch.plan(a, method=method, device="cpu", seed=3, **kw)()
    r2 = repro_torch.plan(a, method=method, device="cpu", seed=3, **kw)()
    assert torch.equal(r1.logabsdet, r2.logabsdet)
    g = torch.Generator().manual_seed(5)
    r3 = repro_torch.plan(a, method=method, device="cpu", seed=3, **kw)(
        generator=g)
    r5 = repro_torch.plan(a, method=method, device="cpu", seed=5, **kw)()
    assert not torch.equal(r3.logabsdet, r1.logabsdet)
    assert torch.equal(r3.logabsdet, r5.logabsdet)
    p = repro_torch.plan(a, method=method, device="cpu", seed=3, **kw)
    s, ld = p.slogdet()
    assert float(s) == 1.0 and torch.equal(ld, r1.logabsdet)
    assert torch.equal(p.logdet(), ld)


def test_estimator_plan_leaves_operator_and_tensor_alone():
    op, _ = _lattice_op()
    bands = op.bands.clone()
    res = repro_torch.plan(op, method="slq", device="cpu", num_probes=4)()
    assert torch.equal(op.bands, bands) and op._bands_t is None
    assert res.diagnostics.matvec_cols == 25 * 4
    a = torch.from_numpy(_matrix(n=20, neg_row=False))
    before = a.clone()
    repro_torch.plan(a, method="chebyshev", device="cpu", degree=8,
                     num_probes=4)()
    assert torch.equal(a, before)


def test_estimator_launch_counts_stay_zero_on_the_cpu():
    ops.reset_launch_counts()
    op, _ = _lattice_op()
    repro_torch.plan(op, method="chebyshev", device="cpu", degree=8,
                     num_probes=4)()
    repro_torch.plan(_matrix(n=20, neg_row=False), method="chebyshev",
                     device="cpu", degree=8, num_probes=4)()
    assert set(ops.launch_counts().values()) == {0}


def test_plan_rejects_an_operator_it_cannot_move():
    """An operator on another device than the plan's is moved through its
    ``to``; one without ``to`` raises when the plan is built."""
    class Duck:
        shape, dtype, device = (4, 4), torch.float64, torch.device("meta")

        def mm(self, v):
            return v

    with pytest.raises(ValueError, match="no .to"):
        repro_torch.plan(Duck(), method="slq", device="cpu")
    op, _ = _lattice_op()
    p = repro_torch.plan(op, method="slq", device="cpu", num_probes=2)
    assert p._bound is op
