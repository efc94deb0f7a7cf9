"""The deprecated string API (`repro_torch.core.api`) and the legacy route
strings, on the CPU, against the JAX package's `repro.core.api`.

* Each shim (``slogdet``, ``logdet``, ``logdet_batched``) against the JAX
  shim on the inputs of tests/test_torch_engine.py, with its tolerances:
  sign exact; log|det| rtol 1e-10 in f64, 1e-4 in f32, ``near_singular``
  in f64 only at 1e-5; the estimators on shared probes at 1e-10 (f64).
* The warnings and the ``compat.deprecated{fn=...}`` counts equal the JAX
  package's.
* Each legacy string is bitwise its ``method="exact"`` route within the
  port (``pmc`` / ``pmc_blocked`` at P = 1 and 2 in gloo ranks); a config
  or keyword that pins another schedule or update is a TypeError in both
  packages; the service takes a legacy string as the JAX service does.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro import obs as jobs
from repro.core import api as japi
from repro.core.configs import ExactConfig as JaxExactConfig
from repro.serve import service as jserve

import test_torch_ranks as ranks
from test_torch_engine import _cases

import repro_torch
from repro_torch import obs
from repro_torch.core import api
from repro_torch.core.configs import METHODS, SLQConfig
from repro_torch.core.engine import LEGACY_ROUTES
from repro_torch.core.mesh import run_ranks
from repro_torch.core.plan import ExactConfig
from repro_torch.serve import LogdetService, ServeConfig

RTOL = {"float64": 1e-10, "float32": 1e-4}
NEAR_SINGULAR_RTOL = 1e-5
EST_RTOL = 1e-10
DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}
SINGLE = ("mc", "mc_staged", "mc_blocked")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _quiet():
    """The shims warn by design; each test that checks a warning asks for
    it with pytest.warns."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield


def _tol(case, dtype):
    return NEAR_SINGULAR_RTOL if case == "near_singular" else RTOL[dtype]


def _case_items():
    for case, a in _cases().items():
        for dtype in DTYPES:
            if dtype == "float32" and case == "near_singular":
                continue
            yield case, dtype, a


def test_method_tuples_match_jax():
    assert METHODS == repro.core.METHODS == api.METHODS
    assert LEGACY_ROUTES == repro.core.engine.LEGACY_ROUTES
    from repro_torch.core import configs
    from repro.core import configs as jconfigs
    for name in ("LEGACY_EXACT_ROUTES", "EXACT_METHODS", "PARALLEL_METHODS",
                 "ESTIMATOR_METHODS", "METHODS"):
        assert getattr(configs, name) == getattr(jconfigs, name), name


@pytest.mark.parametrize("method", SINGLE)
def test_exact_shims_match_jax(method):
    for case, dtype, a in _case_items():
        jdt, tdt = DTYPES[dtype]
        ws, wl = (float(v) for v in japi.slogdet(jnp.asarray(a, jdt),
                                                 method=method))
        s, ld = api.slogdet(torch.from_numpy(a).to(tdt), method=method,
                            device=CPU)
        assert s.dtype == tdt and float(s) == ws, (case, dtype)
        assert float(ld) == pytest.approx(wl, rel=_tol(case, dtype)), \
            (case, dtype)
        only = api.logdet(torch.from_numpy(a).to(tdt), method=method,
                          device=CPU)
        assert torch.equal(only, ld)


@pytest.mark.parametrize("method,kw", [
    ("chebyshev", dict(degree=24, lmin=0.5, lmax=8.0)),
    ("slq", dict(num_steps=12)),
])
def test_estimator_shims_match_jax(method, kw):
    a = _cases()["negative_det"].copy()
    a[3] = -a[3]                                   # back to SPD
    rng = np.random.default_rng(7)
    z = np.where(rng.random((a.shape[0], 16)) < 0.5, -1.0, 1.0)
    want = japi.slogdet(jnp.asarray(a), method=method, probes=z,
                        num_probes=16, **kw)
    got = api.slogdet(torch.from_numpy(a), method=method,
                      probes=torch.from_numpy(z), num_probes=16, device=CPU,
                      **kw)
    assert float(got[0]) == float(want[0]) == 1.0
    assert float(got[1]) == pytest.approx(float(want[1]), rel=EST_RTOL)
    # tensor bounds ride as call inputs (the JAX shim's traced bounds)
    if method == "chebyshev":
        tkw = dict(kw, lmin=torch.tensor(kw["lmin"], dtype=torch.float64))
        again = api.logdet(torch.from_numpy(a), method=method,
                           probes=torch.from_numpy(z), num_probes=16,
                           device=CPU, **tkw)
        assert torch.equal(again, got[1])


@pytest.mark.parametrize("method,kw", [
    ("mc", {}),
    ("slq", dict(num_steps=10)),
    ("chebyshev", dict(degree=24, lmin=0.5, lmax=12.0)),
])
def test_logdet_batched_matches_jax(method, kw):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 17, 34))
    stack = x @ x.transpose(0, 2, 1) / 34 + 2.0 * np.eye(17)
    z = np.where(rng.random((3, 17, 12)) < 0.5, -1.0, 1.0)
    extra = {} if method == "mc" else dict(num_probes=12)
    jprobe = {} if method == "mc" else dict(probes=z)
    tprobe = {} if method == "mc" else dict(probes=torch.from_numpy(z))
    want = np.asarray(japi.logdet_batched(jnp.asarray(stack), method=method,
                                          **jprobe, **extra, **kw))
    got = api.logdet_batched(torch.from_numpy(stack), method=method,
                             device=CPU, **tprobe, **extra, **kw)
    assert got.shape == want.shape == (3,)
    rtol = RTOL["float64"] if method == "mc" else EST_RTOL
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
    if method == "mc":
        np.testing.assert_allclose(got.numpy(), np.linalg.slogdet(stack)[1],
                                   rtol=1e-10)


def test_logdet_batched_rejections_match_jax():
    stack = np.stack([np.eye(4)] * 2)
    for bad, exc in ((np.eye(4), ValueError),):
        with pytest.raises(exc):
            japi.logdet_batched(jnp.asarray(bad))
        with pytest.raises(exc):
            api.logdet_batched(torch.from_numpy(bad), device=CPU)
    from repro_torch.estimators import StencilOperator
    op = StencilOperator((0,), torch.full((1, 4), 2.0))
    with pytest.raises(ValueError, match="batched operator"):
        api.logdet_batched(op, device=CPU)
    assert api.logdet_batched(torch.from_numpy(stack), method="mc_staged",
                              device=CPU).tolist() == [0.0, 0.0]


def test_shims_warn_and_count_as_jax():
    a = _cases()["random"]
    obs.configure("metrics")
    jobs.configure("metrics")
    try:
        obs.reset()
        jobs.reset()
        for name, fn, jfn, x, jx in (
                ("slogdet", api.slogdet, japi.slogdet,
                 torch.from_numpy(a), jnp.asarray(a)),
                ("logdet", api.logdet, japi.logdet,
                 torch.from_numpy(a), jnp.asarray(a)),
                ("logdet_batched", api.logdet_batched, japi.logdet_batched,
                 torch.from_numpy(a[None]), jnp.asarray(a[None]))):
            kw = {"method": "mc"} if name == "logdet_batched" else {}
            with pytest.warns(DeprecationWarning,
                              match=rf"repro_torch\.core\.{name}\(\) is "
                                    "deprecated"):
                fn(x, device=CPU, **kw)
            with pytest.warns(DeprecationWarning,
                              match=rf"repro\.core\.{name}\(\) is "
                                    "deprecated"):
                jfn(jx, **kw)
            for _ in range(2):
                fn(x, device=CPU, **kw)
                jfn(jx, **kw)
            assert obs.counter_value("compat.deprecated", fn=name) == 3
            assert jobs.counter_value("compat.deprecated", fn=name) == 3
    finally:
        obs.configure("off")
        jobs.configure("off")
        obs.reset()
        jobs.reset()
    obs.reset()
    api.slogdet(torch.from_numpy(a), device=CPU)
    assert obs.counter_value("compat.deprecated", fn="slogdet") == 0


@pytest.mark.parametrize("method", SINGLE)
def test_route_strings_warn_as_jax(method):
    schedule, update = LEGACY_ROUTES[method]
    a = _cases()["random"]
    with pytest.warns(DeprecationWarning) as got:
        repro_torch.plan(torch.from_numpy(a), method=method, device=CPU)
    with pytest.warns(DeprecationWarning) as want:
        repro.plan(jnp.asarray(a), method=method)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert f"schedule={schedule!r}, update={update!r}" in str(got[0].message)


@pytest.mark.parametrize("method", SINGLE)
def test_legacy_strings_are_their_exact_routes_bitwise(method):
    schedule, update = LEGACY_ROUTES[method]
    for case, dtype, a in _case_items():
        x = torch.from_numpy(a).to(DTYPES[dtype][1])
        want = repro_torch.plan(x, method="exact", schedule=schedule,
                                update=update, device=CPU)()
        got = repro_torch.plan(x, method=method, device=CPU)()
        shim = api.slogdet(x, method=method, device=CPU)
        for s, ld in ((got.sign, got.logabsdet), shim):
            assert torch.equal(s, want.sign) and \
                torch.equal(ld, want.logabsdet), (case, dtype)


@pytest.mark.parametrize("size", [1, 2])
def test_legacy_mesh_strings_in_ranks(size, mesh1):
    """pmc / pmc_blocked in gloo ranks: bitwise their method="exact" mesh
    plans on every rank, the same on every rank, and at P = 1 the JAX
    shim's values on the mesh1 fixture within the engine's tolerances."""
    cases = _cases()
    results = run_ranks(ranks.legacy_mesh_routes, size, backend="gloo",
                        device=CPU, timeout=240, args=(cases,))
    first = results[0]
    assert len(first) == 2 * 2 * (2 * len(cases) - 1)
    for res in results:
        assert res == first
        assert all(same for _, _, same in res.values())
    for key, (s, ld, _) in first.items():
        case, dtype, method = key.split("|")[:3]
        a = cases[case]
        ws, wl = np.linalg.slogdet(a)
        if size == 1:
            ws, wl = (float(v) for v in japi.slogdet(
                jnp.asarray(a, DTYPES[dtype][0]), method=method,
                mesh=mesh1, k=ranks.PANEL_K))
        assert s == ws, key
        assert ld == pytest.approx(wl, rel=_tol(case, dtype)), key


@pytest.mark.parametrize("kw", [
    dict(method="mc", schedule="staged"),
    dict(method="mc_staged", update="panel"),
    dict(method="mc_blocked", update="rank1"),
    dict(method="mc", config="panel"),
    dict(method="mc_blocked", config="staged"),
])
def test_conflicting_axes_raise_type_error_as_jax(kw):
    a = _cases()["random"]
    kw = dict(kw)
    cfg = kw.pop("config", None)
    jkw, tkw = dict(kw), dict(kw)
    if cfg is not None:
        axis = "update" if cfg in ("panel", "rank1") else "schedule"
        jkw["config"] = JaxExactConfig(**{axis: cfg})
        tkw["config"] = ExactConfig(**{axis: cfg})
    with pytest.raises(TypeError, match="pins"):
        repro.plan(jnp.asarray(a), **jkw)
    with pytest.raises(TypeError, match="pins"):
        repro_torch.plan(torch.from_numpy(a), device=CPU, **tkw)


def test_legacy_config_keeps_its_other_fields():
    a = torch.from_numpy(_cases()["random"])
    p = repro_torch.plan(a, method="mc_blocked", config=ExactConfig(k=8),
                         device=CPU)
    assert (p.method, p.config.schedule, p.config.update, p.config.k) == \
        ("exact", "serial", "panel", 8)
    with pytest.raises(TypeError, match="ExactConfig"):
        repro_torch.plan(a, method="mc", config=SLQConfig(), device=CPU)
    with pytest.raises(ValueError, match="requires a mesh"):
        repro_torch.plan(a, method="pmc", device=CPU)
    with pytest.raises(ValueError, match="unknown method"):
        api.slogdet(a, method="mcx", device=CPU)
    with pytest.raises(ValueError, match="square"):
        api.slogdet(a[:3], device=CPU)
    with pytest.raises(TypeError, match="estimator keywords"):
        api.slogdet(a, method="mc", num_probes=4, device=CPU)


def test_service_takes_a_legacy_string():
    rng = np.random.default_rng(5)
    mats = [rng.standard_normal((n, n)) + 3.0 * np.eye(n) for n in (6, 12)]
    cfg = dict(buckets=(8, 16), max_batch=2, max_wait_ms=1.0)
    with LogdetService(ServeConfig(device=CPU, **cfg)) as svc:
        got = [svc.submit(a, method="mc_staged").result(timeout=60)
               for a in mats]
    with jserve.LogdetService(jserve.ServeConfig(**cfg)) as jsvc:
        want = [jsvc.submit(a, method="mc_staged").result(timeout=60)
                for a in mats]
    for a, g, w in zip(mats, got, want):
        assert g.sign == float(w.sign) and g.method_used == "exact"
        assert g.logabsdet == pytest.approx(float(w.logabsdet), rel=1e-12)
        assert g.logabsdet == pytest.approx(np.linalg.slogdet(a)[1],
                                            rel=1e-12)
    assert ServeConfig(default_method="pmc", device=CPU).default_method == \
        "pmc"
