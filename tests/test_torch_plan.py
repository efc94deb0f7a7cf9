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
    d = jax_config_to_dict(repro.core.configs.ExactConfig(schedule="mesh"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_jax_config(d)
    d = jax_config_to_dict(repro.core.configs.ExactConfig(lookahead=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_jax_config(d)
    d = jax_config_to_dict(repro.core.configs.ChebyshevConfig())
    with pytest.raises(ValueError, match="ChebyshevConfig"):
        from_jax_config(d)


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


@pytest.mark.parametrize("method", ["auto", "chebyshev", "slq", "ge", "pge",
                                    "plu", "mc", "mc_staged", "mc_blocked",
                                    "pmc", "pmc_blocked"])
def test_unported_methods_name_their_roadmap_item(method):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        repro_torch.plan(_matrix(), method=method, device="cpu")


@pytest.mark.parametrize("kw,exc", [
    ({"mesh": object()}, NotImplementedError),
    ({"grad": True}, NotImplementedError),
    ({"schedule": "mesh"}, NotImplementedError),
    ({"lookahead": True}, NotImplementedError),
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


def test_rejected_inputs_raise():
    with pytest.raises(NotImplementedError, match="batched"):
        repro_torch.plan((2, 8, 8), method="exact", device="cpu")
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
    p = repro_torch.plan(_matrix(), method="exact", device="cpu")
    for call in (p.value_and_grad, p.audit, p.explain,
                 lambda: p.export("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


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
    files.append(ROOT / "chip_smoke.py")
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
