"""The port's serving layer (`repro_torch.serve`) on the CPU, against the
JAX package's (`repro.serve`) on the same numpy inputs.

Each test of tests/test_serve.py has its counterpart here, with
``device="cpu"`` and buckets of 8/16/32:

- **Helpers.**  `BucketLadder`, `bucket_batch`, `pad_to_bucket`,
  `stack_to_bucket`, `coalesce` and `admit`'s rejections equal the JAX
  package's bit for bit (messages included).
- **Service.**  A mixed-size drain gives, per request and in submission
  order, the JAX service's sign and its log|det| within 1e-12 relative
  (f64); the drain repeated 20 times reads ``serve.responses`` exactly
  after every drain (the port records a batch's metrics before it
  resolves the futures); estimator requests within the JAX test's
  tolerance and bitwise the port's own plan on the same padded stack and
  generator; after ``warmup()`` a drain builds no plan (no
  ``serve.plan_cache.misses``); a cancelled queued request is dropped
  from its batch.  The JAX package's ``trace_count`` has
  no counterpart: nothing is traced.
- **Artifacts.**  Export and load are bitwise (in this process and in a
  fresh one that imports neither jax nor repro), leave the live plan as
  it was, make execute-only plans, refuse a tampered fingerprint, the
  other package's file ("bad magic"), and mesh and operator plans.
- **Front ends.**  The HTTP service answers with the JAX package's JSON
  keys; ``tools/serve_smoke_torch.py --device cpu`` passes.

Every future is waited on with a timeout and every service is closed.
"""
import dataclasses
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
from repro import obs as jobs
from repro import serve as jserve
from repro.serve import aot as jaot
from repro.serve import batching as jbatching
from repro.serve.http import _result_json as jax_result_json

from _subproc import SRC

import repro_torch
from repro_torch import obs
from repro_torch.core.mesh import Mesh
from repro_torch.estimators import StencilOperator
from repro_torch.serve import (
    BucketLadder, LogdetService, PlanCache, ServeConfig, ServiceClosed,
    bucket_batch, coalesce, pad_to_bucket, stack_to_bucket,
)
from repro_torch.serve.aot import (
    PlanExportError, PlanFingerprintError, read_header,
)
from repro_torch.serve import batching as tbatching
from repro_torch.serve.batching import Request, admit

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
MIXED = (5, 8, 13, 16, 30, 7, 9, 32)
TIMEOUT = 120


@pytest.fixture
def metrics():
    """Metrics-mode obs (the port's) with a clean registry, restored
    afterwards."""
    prev = obs.mode()
    obs.configure("metrics")
    obs.reset()
    yield obs
    obs.reset()
    obs.configure(prev)


def _spd(rng, n):
    a = rng.standard_normal((n, n)) * 0.05
    return np.eye(n) * 2.0 + (a + a.T) / 2


def _raised(fn, *args, **kwargs) -> str:
    """The message of the ValueError ``fn`` raises."""
    with pytest.raises(ValueError) as err:
        fn(*args, **kwargs)
    return str(err.value)


# ---------------------------------------------------------------- ladder

def test_ladder_boundaries():
    lad, jlad = BucketLadder((8, 16, 32)), jserve.BucketLadder((8, 16, 32))
    assert lad.bucket_for(1) == 8
    assert lad.bucket_for(8) == 8        # exactly on a rung
    assert lad.bucket_for(9) == 16       # just over
    assert lad.bucket_for(16) == 16
    assert lad.bucket_for(17) == 32
    assert lad.bucket_for(32) == 32
    assert [lad.bucket_for(n) for n in range(1, 33)] \
        == [jlad.bucket_for(n) for n in range(1, 33)]
    assert "exceeds the top bucket" in _raised(lad.bucket_for, 33)
    for n in (0, 33):
        assert _raised(lad.bucket_for, n) == _raised(jlad.bucket_for, n)


def test_ladder_sorts_and_dedupes():
    assert BucketLadder((32, 8, 8, 16)).buckets == (8, 16, 32) \
        == jserve.BucketLadder((32, 8, 8, 16)).buckets
    with pytest.raises(ValueError):
        BucketLadder(())
    with pytest.raises(ValueError):
        BucketLadder((0, 8))
    assert BucketLadder().buckets == jserve.BucketLadder().buckets


def test_bucket_batch():
    assert bucket_batch(1, 8) == 1
    assert bucket_batch(2, 8) == 2
    assert bucket_batch(3, 8) == 4
    assert bucket_batch(5, 8) == 8
    assert bucket_batch(8, 8) == 8
    assert bucket_batch(100, 8) == 8     # capped
    for cap in range(1, 17):
        assert [bucket_batch(m, cap) for m in range(1, 21)] \
            == [jserve.bucket_batch(m, cap) for m in range(1, 21)]
    assert _raised(bucket_batch, 0, 8) == _raised(jserve.bucket_batch, 0, 8)


def test_padding_preserves_slogdet(rng):
    a = rng.standard_normal((5, 5))
    padded = pad_to_bucket(a, 8)
    s0, ld0 = np.linalg.slogdet(a)
    s1, ld1 = np.linalg.slogdet(padded)
    assert s0 == s1
    assert ld1 == pytest.approx(ld0, abs=1e-12)
    for dtype in (np.float32, np.float64):
        want = jserve.pad_to_bucket(a, 8, dtype)
        got = pad_to_bucket(a, 8, dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_stack_identity_filler(rng):
    mats = [rng.standard_normal((5, 5)), rng.standard_normal((7, 7))]
    stack = stack_to_bucket(mats, 8, 4)
    assert stack.shape == (4, 8, 8)
    for i, m in enumerate(mats):
        assert np.linalg.slogdet(stack[i])[1] == pytest.approx(
            np.linalg.slogdet(m)[1], abs=1e-12)
    for i in (2, 3):                     # filler slots: exact identity
        np.testing.assert_array_equal(stack[i], np.eye(8))
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(
            stack_to_bucket(mats, 8, 4, dtype),
            jserve.stack_to_bucket(mats, 8, 4, dtype))
    np.testing.assert_array_equal(stack_to_bucket([], 16, 2),
                                  jserve.stack_to_bucket([], 16, 2))


# ------------------------------------------------------------ plan cache

def test_plan_cache_lru_eviction_order(metrics):
    cache = PlanCache(capacity=2)
    cache.put(("a",), 1)
    cache.put(("b",), 2)
    assert cache.get(("a",)) == 1        # touch "a": "b" is now oldest
    cache.put(("c",), 3)                 # evicts "b"
    assert cache.keys() == [("a",), ("c",)]
    assert cache.get(("b",)) is None
    assert obs.counter_value("serve.plan_cache.evictions") == 1
    built = cache.get(("d",), lambda: 4)  # builder path evicts "a"
    assert built == 4
    assert cache.keys() == [("c",), ("d",)]
    assert obs.counter_value("serve.plan_cache.evictions") == 2
    assert obs.counter_value("serve.plan_cache.hits") == 1
    assert obs.counter_value("serve.plan_cache.misses") == 2
    assert obs.snapshot()["gauges"]["serve.plan_cache.size"] == 2
    with pytest.raises(ValueError):
        PlanCache(capacity=0)


# ------------------------------------------------------------- coalescing

def _admitted(pkg, mats_methods, ladder):
    return [pkg.admit(a, ladder, method=m, rtol=None, dtype=np.float64)
            for a, m in mats_methods]


def _groups(groups):
    return [(g.bucket, g.method, g.rtol, [r.n for r in g.requests])
            for g in groups]


def test_coalesce_groups_and_fifo(rng):
    lad = BucketLadder((8, 16))
    traffic = [(rng.standard_normal((n, n)), m)
               for n, m in [(5, "exact"), (12, "exact"), (7, "exact"),
                            (6, "chebyshev"), (8, "exact")]]
    reqs = _admitted(tbatching, traffic, lad)
    groups = coalesce(reqs, max_batch=8)
    keys = [(g.bucket, g.method) for g in groups]
    assert sorted(keys) == [(8, "chebyshev"), (8, "exact"), (16, "exact")]
    assert groups[0].oldest <= groups[1].oldest <= groups[2].oldest
    exact8 = next(g for g in groups if (g.bucket, g.method) == (8, "exact"))
    assert [r.n for r in exact8.requests] == [5, 7, 8]  # admission order
    jreqs = _admitted(jbatching, traffic, jserve.BucketLadder((8, 16)))
    for cap in (1, 2, 8):
        assert _groups(coalesce(reqs, max_batch=cap)) \
            == _groups(jserve.coalesce(jreqs, max_batch=cap))
    for got, want in zip(reqs, jreqs):
        np.testing.assert_array_equal(got.a, want.a)


def test_coalesce_chunks_at_max_batch():
    reqs = [Request(a=np.eye(2), n=2, bucket=8, method="exact", rtol=None)
            for _ in range(5)]
    groups = coalesce(reqs, max_batch=2)
    assert [len(g.requests) for g in groups] == [2, 2, 1]
    flat = [r.id for g in groups for r in g.requests]
    assert flat == sorted(flat)          # FIFO across the chunks
    with pytest.raises(ValueError, match="max_batch"):
        coalesce(reqs, max_batch=0)


def test_admit_rejects_bad_input(rng):
    lad, jlad = BucketLadder((8,)), jserve.BucketLadder((8,))
    bad = np.eye(4)
    bad[0, 0] = np.nan
    for a, match in ((rng.standard_normal((4, 5)), "square"),
                     (bad, "non-finite"),
                     (np.eye(9), "exceeds the top bucket")):
        msg = _raised(admit, a, lad, method="exact", rtol=None,
                      dtype=np.float64)
        assert match in msg
        assert msg == _raised(jbatching.admit, a, jlad, method="exact",
                              rtol=None, dtype=np.float64)


# -------------------------------------------------------------- artifacts

def _exact_plan(n, **kw):
    return repro_torch.plan((n, n), method="exact", precision="float64",
                            validate=False, device=CPU, **kw)


def test_aot_roundtrip_bit_identical(tmp_path, rng, metrics):
    a = rng.standard_normal((12, 12))
    p = _exact_plan(12)
    want = p(a)
    path = str(tmp_path / "p.repro-torch-plan")
    assert p.export(path) == path
    q = repro_torch.load_plan(path, device=CPU)
    got = q(a)
    assert torch.equal(got.logabsdet, want.logabsdet)      # bit-identical
    assert torch.equal(got.sign, want.sign)
    assert torch.equal(q(a).logabsdet, want.logabsdet)
    assert got.method_used == "exact"
    assert q.config == p.config and q.spec == p.spec
    assert q.diagnostics == p.diagnostics
    assert obs.counter_value("serve.aot.exports", method="exact") == 1
    assert obs.counter_value("serve.aot.loads", method="exact") == 1
    # a stack plan too: each matrix bitwise the live stack plan's
    stack = np.stack([rng.standard_normal((12, 12)) for _ in range(3)])
    ps = repro_torch.plan(stack.shape, method="exact", precision="float64",
                          validate=False, device=CPU)
    ps.export(path)
    qs = repro_torch.load_plan(path, device=CPU)
    assert torch.equal(qs(stack).logabsdet, ps(stack).logabsdet)


def test_aot_export_does_not_touch_live_plan(rng, tmp_path, metrics):
    p = _exact_plan(12)
    p(rng.standard_normal((12, 12)))
    before = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    cache = dict(p._cache)
    executions = obs.counter_value("plan.executions", method="exact")
    path = str(tmp_path / "p.repro-torch-plan")
    p.export(path)
    assert {f.name: getattr(p, f.name)
            for f in dataclasses.fields(p)} == before
    assert p._cache == cache
    # export runs nothing
    assert obs.counter_value("plan.executions", method="exact") == executions
    assert read_header(path)["config"] == {"type": "ExactConfig",
                                           **dataclasses.asdict(p.config)}


def test_aot_estimator_roundtrip(tmp_path, rng):
    a = _spd(rng, 16)
    p = repro_torch.plan((16, 16), method="slq", precision="float64",
                         validate=False, device=CPU)
    want = p(a).logabsdet
    path = str(tmp_path / "slq.repro-torch-plan")
    p.export(path)
    assert read_header(path)["key"] == {"kind": "torch.Generator",
                                        "seed": 0}
    q = repro_torch.load_plan(path, device=CPU)
    assert torch.equal(q(a).logabsdet, want)    # default generator: seed
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    assert torch.equal(q(a, generator=g1).logabsdet,
                       p(a, generator=g2).logabsdet)
    with pytest.raises(TypeError, match="probes"):
        q(a, probes=np.ones((16, 4)))


def test_aot_loaded_plan_is_execute_only(tmp_path, rng):
    path = str(tmp_path / "p.repro-torch-plan")
    _exact_plan(8).export(path)
    q = repro_torch.load_plan(path, device=CPU)
    a = rng.standard_normal((8, 8))
    with pytest.raises(TypeError, match="takes no generator"):
        q(a, generator=torch.Generator().manual_seed(0))
    x = torch.tensor(a, requires_grad=True)
    with pytest.raises(TypeError, match="execute-only"):
        q.logdet(x)
    with pytest.raises(NotImplementedError, match="execute-only"):
        q.value_and_grad(a)
    epath = str(tmp_path / "cheb.repro-torch-plan")
    repro_torch.plan((8, 8), method="chebyshev", precision="float64",
                     device=CPU).export(epath)
    e = repro_torch.load_plan(epath, device=CPU)
    for kw in ({"lmin": 0.5}, {"lmax": 4.0}):
        with pytest.raises(TypeError, match="accept `generator` only"):
            e(_spd(rng, 8), **kw)


def _tampered(path, tmp_path, **fingerprint) -> str:
    raw = open(path, "rb").read()
    magic_len = len(b"REPROTORCHPLAN\x00")
    (hlen,) = struct.unpack_from("<I", raw, magic_len)
    start = magic_len + 4
    header = json.loads(raw[start:start + hlen])
    header["fingerprint"].update(fingerprint)
    new_head = json.dumps(header, sort_keys=True).encode()
    bad = tmp_path / "tampered.repro-torch-plan"
    bad.write_bytes(raw[:magic_len] + struct.pack("<I", len(new_head))
                    + new_head + raw[start + hlen:])
    return str(bad)


def test_aot_header_and_fingerprint_mismatch(tmp_path, rng):
    path = str(tmp_path / "p.repro-torch-plan")
    _exact_plan(8).export(path)
    header = read_header(path)
    assert header["format"] == 1
    assert header["method"] == "exact"
    assert header["spec"]["n"] == 8
    fp = header["fingerprint"]
    assert fp["platform"] == "cpu"
    assert fp["torch_version"] == torch.__version__
    # the fields that mean nothing on the CPU are null
    for key in ("device_kind", "device_count", "capability", "cuda_version",
                "kernel_build"):
        assert fp[key] is None
    # the JAX package's header keys
    jpath = str(tmp_path / "j.repro-plan")
    repro.plan((8, 8), method="exact", validate=False).export(jpath)
    assert set(header) == set(jaot.read_header(jpath))

    bad = _tampered(path, tmp_path, torch_version="9.9.9")
    with pytest.raises(PlanFingerprintError, match="torch_version"):
        repro_torch.load_plan(bad, device=CPU)
    # the escape hatch skips the check (same process, so actually safe)
    q = repro_torch.load_plan(bad, device=CPU, check_device=False)
    a = rng.standard_normal((8, 8))
    assert np.isfinite(float(q(a).logabsdet))
    # a CPU artifact on another platform is refused by name too
    other = _tampered(path, tmp_path, platform="cuda")
    with pytest.raises(PlanFingerprintError, match="platform"):
        repro_torch.load_plan(other, device=CPU)


def test_aot_rejects_non_artifact(tmp_path):
    junk = tmp_path / "junk.repro-torch-plan"
    junk.write_bytes(b"definitely not a plan")
    with pytest.raises(PlanExportError, match="bad magic"):
        repro_torch.load_plan(str(junk), device=CPU)
    # each package refuses the other's artifact
    jpath = str(tmp_path / "j.repro-plan")
    repro.plan((8, 8), method="exact", validate=False).export(jpath)
    with pytest.raises(PlanExportError, match="bad magic"):
        repro_torch.load_plan(jpath, device=CPU)
    tpath = str(tmp_path / "t.repro-torch-plan")
    _exact_plan(8).export(tpath)
    with pytest.raises(jaot.PlanExportError, match="bad magic"):
        repro.load_plan(tpath)


def test_aot_rejects_mesh_and_operator_plans(tmp_path):
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device(CPU))
    path = str(tmp_path / "x.repro-torch-plan")
    for method in ("exact", "slq"):
        p = repro_torch.plan((16, 16), method=method, mesh=mesh,
                             validate=False)
        with pytest.raises(PlanExportError, match="mesh"):
            p.export(path)
    bands = torch.ones(3, 16, dtype=torch.float64)
    bands[1] = 4.0
    op = StencilOperator((-1, 0, 1), bands)
    p = repro_torch.plan(op, method="slq", device=CPU)
    with pytest.raises(PlanExportError, match="operator"):
        p.export(path)
    assert not os.path.exists(path)


def test_aot_cross_process_bit_identical(tmp_path, rng):
    """Export here, load in a fresh process that imports neither jax nor
    repro: bit-identical sign and log|det|."""
    a = rng.standard_normal((12, 12))
    p = _exact_plan(12)
    want = p(a)
    path = str(tmp_path / "x.repro-torch-plan")
    p.export(path)
    np.save(tmp_path / "a.npy", a)
    code = f"""
import sys
import numpy as np
import repro_torch
q = repro_torch.load_plan({path!r}, device="cpu")
r = q(np.load({str(tmp_path / 'a.npy')!r}))
assert "jax" not in sys.modules and "repro" not in sys.modules
print(repr(float(r.sign)), repr(float(r.logabsdet)))
"""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    sign, ld = (float(v) for v in proc.stdout.split())
    assert sign == float(want.sign)
    assert ld == float(want.logabsdet)


# --------------------------------------------------------------- service

def test_serve_config_validation():
    with pytest.raises(ValueError, match="max_batch"):
        ServeConfig(max_batch=0, device=CPU)
    with pytest.raises(ValueError, match="max_wait_ms"):
        ServeConfig(max_wait_ms=-1, device=CPU)
    with pytest.raises(ValueError, match="default_method"):
        ServeConfig(default_method="nope", device=CPU)
    assert ServeConfig(buckets=(32, 8, 16), device=CPU).buckets == (8, 16, 32)
    cfg, jcfg = ServeConfig(device=CPU), jserve.ServeConfig()
    assert cfg.device == torch.device(CPU)
    # the JAX package's fields and defaults, and one more: device
    jfields = {f.name: getattr(jcfg, f.name)
               for f in dataclasses.fields(jcfg)}
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "device"} == jfields


def test_serve_default_device_needs_a_card(tmp_path, monkeypatch):
    path = str(tmp_path / "p.repro-torch-plan")
    _exact_plan(8).export(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServeConfig()
    with pytest.raises(RuntimeError, match="CUDA device"):
        LogdetService()
    with pytest.raises(RuntimeError, match="CUDA device"):
        repro_torch.load_plan(path)


def _jax_results(mats, **cfg):
    with jserve.LogdetService(jserve.ServeConfig(**cfg)) as jsvc:
        futs = [jsvc.submit(a) for a in mats]
        return [f.result(timeout=TIMEOUT) for f in futs]


def test_service_mixed_size_drain_matches_jax(rng, metrics):
    cfg = dict(buckets=(8, 16, 32), max_batch=4, max_wait_ms=1.0)
    mats = [rng.standard_normal((n, n)) for n in MIXED]
    want = _jax_results(mats, **cfg)
    with LogdetService(ServeConfig(device=CPU, **cfg)) as svc:
        svc.warmup()
        misses = obs.counter_value("serve.plan_cache.misses")
        futs = [svc.submit(a) for a in mats]
        for a, f, w in zip(mats, futs, want):   # results in submission order
            res = f.result(timeout=TIMEOUT)
            assert isinstance(res.logabsdet, np.floating)   # host values
            assert res.sign == float(w.sign)
            assert abs(res.logabsdet - float(w.logabsdet)) \
                <= 1e-12 * abs(float(w.logabsdet))
            assert res.sem == 0.0
            assert res.method_used == w.method_used == "exact"
            assert res.diagnostics.padded_n == w.diagnostics.padded_n
            assert res.logabsdet == pytest.approx(np.linalg.slogdet(a)[1],
                                                  abs=1e-8)
        assert obs.counter_value("serve.plan_cache.misses") == misses
        assert obs.counter_value("serve.responses", status="ok") == 8
        stats = svc.stats()
        assert stats["quantiles"]["serve.batch_size"]["p50"] is not None
        assert stats["auto_resolution"] == {"n8": "exact", "n16": "exact",
                                            "n32": "exact"}
    with jserve.LogdetService(jserve.ServeConfig(**cfg)) as jsvc:
        jkeys = set(jsvc.stats())
    assert set(stats) == (jkeys - {"trace_count"}) | {"device",
                                                      "kernel_loads"}
    assert stats["device"] == "cpu" and stats["kernel_loads"] == 0


def test_service_response_counter_exact_every_drain(rng, metrics):
    """The counters a client reads after its last result include that
    result's batch, in every one of 20 drains."""
    cfg = ServeConfig(buckets=(8, 16, 32), max_batch=4, max_wait_ms=1.0,
                      device=CPU)
    mats = [rng.standard_normal((n, n)) for n in MIXED]
    with LogdetService(cfg) as svc:
        for i in range(20):
            futs = [svc.submit(a) for a in mats]
            for f in futs:
                f.result(timeout=TIMEOUT)
            assert obs.counter_value("serve.responses", status="ok") \
                == 8 * (i + 1), f"drain {i}"
            h = obs.snapshot()["histograms"]["serve.batch_size"]
            assert h["sum"] == 8 * (i + 1), f"drain {i}"


def test_service_estimator_requests(rng):
    """Each served estimator result is bitwise the port's own plan on the
    same padded stack, with the generator the service draws for that
    batch (seeded by its batch counter): a single request and a pair, so
    that the (B,) results are split back by position."""
    cfg = ServeConfig(buckets=(16,), max_batch=2, max_wait_ms=1000.0,
                      device=CPU, seed=5)
    counter = cfg.seed
    with LogdetService(cfg) as svc:
        for method in ("chebyshev", "slq"):
            for mats in ([_spd(rng, 14)], [_spd(rng, 9), _spd(rng, 16)]):
                futs = [svc.submit(a, method=method) for a in mats]
                got = [f.result(timeout=TIMEOUT) for f in futs]
                batch = bucket_batch(len(mats), 2)
                stack = stack_to_bucket(mats, 16, batch)
                want = repro_torch.plan(
                    stack.shape if batch > 1 else stack[0].shape,
                    method=method, precision="float64", validate=False,
                    device=CPU)(stack if batch > 1 else stack[0],
                                generator=torch.Generator().manual_seed(
                                    counter))
                counter += 1
                for i, (a, res) in enumerate(zip(mats, got)):
                    assert res.method_used == method
                    assert isinstance(res.logabsdet, np.floating)
                    for field in ("sign", "logabsdet", "sem"):
                        w = getattr(want, field).reshape(-1)[i].item()
                        assert getattr(res, field) == w, (method, i, field)
                    assert float(res.logabsdet) == pytest.approx(
                        np.linalg.slogdet(a)[1], rel=0.1)
                    assert np.isfinite(float(res.sem))


def test_service_warmup_identity_estimators():
    """Warmup runs every plan on identity stacks: the estimators give
    log|det| 0 and sem 0 there, no NaN (Lanczos breaks down at once)."""
    eye = stack_to_bucket([], 16, 4)
    for method in ("slq", "chebyshev"):
        res = repro_torch.plan(eye.shape, method=method,
                               precision="float64", validate=False,
                               device=CPU)(eye)
        assert torch.equal(res.sign, torch.ones(4, dtype=torch.float64))
        assert torch.all(res.logabsdet.abs() <= 1e-12), res.logabsdet
        assert torch.all(torch.isfinite(res.sem))


def test_service_warmup_then_no_plan_builds(rng, metrics):
    cfg = ServeConfig(buckets=(8, 16), max_batch=2, max_wait_ms=0.0,
                      default_method="exact", device=CPU)
    with LogdetService(cfg) as svc:
        svc.warmup()
        misses = obs.counter_value("serve.plan_cache.misses")
        assert misses == len(svc.plans) == 4
        futs = [svc.submit(rng.standard_normal((n, n)))
                for n in (3, 8, 11, 16, 5)]
        for f in futs:
            assert np.isfinite(float(f.result(timeout=TIMEOUT).logabsdet))
        assert obs.counter_value("serve.plan_cache.misses") == misses
        assert obs.counter_value("serve.plan_cache.hits") >= 3


def test_service_drain_failure_fails_futures(rng, monkeypatch):
    cfg = ServeConfig(buckets=(8,), max_batch=2, device=CPU)
    svc = LogdetService(cfg)
    monkeypatch.setattr(svc, "_build_plan",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("boom")))
    try:
        fut = svc.submit(np.eye(4))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=60)
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.eye(4))


def test_service_close_fails_queued_requests(rng, monkeypatch):
    cfg = ServeConfig(buckets=(8,), max_batch=1, max_wait_ms=0.0,
                      device=CPU)
    svc = LogdetService(cfg)
    entered, release = threading.Event(), threading.Event()

    def wedge(group):
        entered.set()
        release.wait(60)

    monkeypatch.setattr(svc, "_run_group", wedge)
    try:
        first = svc.submit(np.eye(4))
        assert entered.wait(30)          # drain popped `first` and wedged
        queued = svc.submit(np.eye(4))   # stays queued behind the wedge

        got = {}

        def client():
            try:
                got["res"] = queued.result(timeout=60)
            except Exception as exc:     # noqa: BLE001 -- recorded for assert
                got["exc"] = exc

        t = threading.Thread(target=client)
        t.start()
        svc.close(timeout=0.2)           # wedged drain: join times out
        t.join(30)
        assert not t.is_alive(), "client is still blocked on a dead request"
        assert isinstance(got.get("exc"), ServiceClosed)
        with pytest.raises(ServiceClosed, match="closed"):
            svc.submit(np.eye(4))
    finally:
        release.set()                    # unwedge so the thread can exit
    # once the drain resumes and exits, the popped-but-unprocessed request
    # is failed too (drain-exit cleanup), not leaked
    with pytest.raises(ServiceClosed):
        first.result(timeout=30)


def test_service_drops_cancelled_requests(rng, metrics):
    """A request its client cancelled while it was queued is dropped from
    its batch (a deliberate difference: the JAX service runs it): the
    batch shrinks to the live requests, and the counters count only
    them."""
    cfg = ServeConfig(buckets=(8,), max_batch=4, max_wait_ms=0.0,
                      device=CPU)
    svc = LogdetService(cfg)
    entered, release = threading.Event(), threading.Event()
    run_group = svc._run_group

    def held_first(group):
        if not entered.is_set():
            entered.set()
            release.wait(60)
        run_group(group)

    svc._run_group = held_first
    mats = [rng.standard_normal((n, n)) for n in (5, 6, 7, 8)]
    try:
        first = svc.submit(mats[0])
        assert entered.wait(30)          # the drain holds `first`'s batch
        queued = [svc.submit(a) for a in mats[1:]]
        assert queued[1].cancel()
        release.set()
        for a, f in zip([mats[0], mats[1], mats[3]],
                        [first, queued[0], queued[2]]):
            assert f.result(timeout=TIMEOUT).logabsdet == pytest.approx(
                np.linalg.slogdet(a)[1], abs=1e-10)
        assert queued[1].cancelled()
    finally:
        release.set()
        svc.close()
    assert obs.counter_value("serve.requests", method="auto") == 4
    assert obs.counter_value("serve.responses", status="ok") == 3
    assert obs.counter_value("serve.batches", method="exact", bucket=8) == 2
    h = obs.snapshot()["histograms"]["serve.batch_size"]
    assert (h["count"], h["sum"]) == (2, 3)      # batches of 1 and 2
    assert obs.counter_value("serve.responses", status="closed") == 0


def test_service_submit_rejections(rng):
    cfg = ServeConfig(buckets=(8,), max_batch=2, device=CPU)
    with LogdetService(cfg) as svc:
        with pytest.raises(ValueError, match="exceeds the top bucket"):
            svc.submit(np.eye(9))
        with pytest.raises(ValueError, match="unknown method"):
            svc.submit(np.eye(4), method="nope")
        with pytest.raises(ValueError, match="square"):
            svc.submit(np.ones((3, 4)))


def test_service_plan_dir_loads_exported_plans(tmp_path, rng, metrics):
    """A plan_dir-backed service loads every plan, at warmup."""
    from repro_torch.serve.__main__ import main as serve_main
    serve_main(["export", "--out", str(tmp_path), "--buckets", "8",
                "--max-batch", "2", "--method", "exact", "--device", CPU])
    assert sorted(os.listdir(tmp_path)) == [
        "exact-n8-B1-float64.repro-torch-plan",
        "exact-n8-B2-float64.repro-torch-plan"]
    cfg = ServeConfig(buckets=(8,), max_batch=2, plan_dir=str(tmp_path),
                      default_method="exact", device=CPU)
    with LogdetService(cfg) as svc:
        svc.warmup()
        assert obs.counter_value("serve.aot.loads", method="exact") == 2
        plans = [svc.plans.get(k) for k in svc.plans.keys()]
        assert all("aot_path" in p._cache for p in plans)
        a = rng.standard_normal((6, 6))
        res = svc.logdet(a, timeout=TIMEOUT)
        assert float(res.logabsdet) == pytest.approx(
            np.linalg.slogdet(a)[1], abs=1e-8)
        assert obs.counter_value("serve.aot.loads", method="exact") == 2


# ------------------------------------------------------------------ HTTP

def test_http_roundtrip(rng, metrics):
    from repro_torch.serve.http import serve_http

    cfg = ServeConfig(buckets=(8,), max_batch=2, max_wait_ms=0.5,
                      device=CPU)
    with LogdetService(cfg) as svc:
        server = serve_http(svc, port=0)
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            base = f"http://127.0.0.1:{port}"
            a = rng.standard_normal((6, 6)) + np.eye(6) * 4

            req = urllib.request.Request(
                f"{base}/v1/logdet",
                data=json.dumps({"matrix": a.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                assert resp.status == 200
                body = json.load(resp)
            assert body["logabsdet"] == pytest.approx(
                np.linalg.slogdet(a)[1], abs=1e-8)
            assert body["bucket"] == 8
            # the JAX front end's keys
            jres = repro.plan(jserve.pad_to_bucket(a, 8), method="exact",
                              validate=False)()
            assert set(body) == set(jax_result_json(jres))

            multi = urllib.request.Request(
                f"{base}/v1/logdet",
                data=json.dumps(
                    {"matrices": [a.tolist(), (2 * np.eye(3)).tolist()],
                     "method": "exact"}).encode())
            with urllib.request.urlopen(multi, timeout=TIMEOUT) as resp:
                results = json.load(resp)["results"]
            assert results[1]["logabsdet"] == pytest.approx(
                3 * np.log(2.0), abs=1e-10)

            with urllib.request.urlopen(f"{base}/healthz",
                                        timeout=30) as resp:
                assert json.load(resp)["status"] == "ok"
            with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
                stats = json.load(resp)
            assert stats["buckets"] == [8] and stats["device"] == CPU
            with urllib.request.urlopen(f"{base}/metrics",
                                        timeout=30) as resp:
                text = resp.read().decode()
            assert 'repro_torch_serve_responses_total{status="ok"} 3' in text

            bad = urllib.request.Request(
                f"{base}/v1/logdet",
                data=json.dumps({"matrix": [[1, 2, 3]]}).encode())
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(bad, timeout=30)
            assert err.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}/nope", timeout=30)
            assert err.value.code == 404
        finally:
            server.shutdown()
            server.server_close()


def test_serve_smoke_tool_on_cpu():
    """tools/serve_smoke_torch.py: the real entry point in a subprocess,
    one request over HTTP, no plan built after warmup."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "serve_smoke_torch.py"),
         "--device", CPU], env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "serve smoke OK on cpu" in proc.stdout


# -------------------------------------------------------------- quantile

def test_obs_quantile(metrics):
    for v in range(1, 101):
        obs.observe("q.test", float(v))
    assert obs.quantile("q.test", 0.5) == pytest.approx(50.5)
    assert obs.quantile("q.test", 0.99) == pytest.approx(99.01)
    assert obs.quantile("q.test", 0.0) == 1.0
    assert obs.quantile("q.test", 1.0) == 100.0
    assert obs.quantile("nothing.observed", 0.5) is None
    with pytest.raises(ValueError):
        obs.quantile("q.test", 1.5)
    # the histogram summary dict shape is the JAX package's
    h = obs.snapshot()["histograms"]["q.test"]
    assert h == {"count": 100.0, "sum": 5050.0, "min": 1.0, "max": 100.0}
    prev = jobs.mode()
    jobs.configure("metrics")
    jobs.reset()
    try:
        for v in range(1, 101):
            jobs.observe("q.test", float(v))
        for q in (0.0, 0.5, 0.99, 1.0):
            assert obs.quantile("q.test", q) == jobs.quantile("q.test", q)
    finally:
        jobs.reset()
        jobs.configure(prev)
