"""The port's cost model (`repro_torch.core.calibration`, `kernels.autotune`,
`select_route` / `select_method`) and ``method="auto"`` against the JAX
package, on the CPU.

On every table in the JAX package's format -- its `STATIC_DEFAULT`, its
committed CPU table (``bench_out/roofline_calibration.json``) and a
synthetic H100-like one -- the port's `select_route`, `select_method`,
`resolved_panel_k`, `exact_cost` and `estimator_cost` equal the JAX
package's exactly, over n from 16 to 65536, stacks, 1 / 2 / 4 / 8
devices (`ProblemSpec.device_count`, or a port `Mesh`), ``rtol``,
``bounds_known`` and ``precision="bf16"``.  The port's host terms move
the crossover and leave the panel width alone.  ``method="auto"`` plans
run on the CPU at the route and width the selector names.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core.plan import ProblemSpec as JaxSpec
from repro.core.plan import select_method as jax_select_method
from repro.core.plan import select_route as jax_select_route
from repro.core.plan import spec_of as jax_spec_of
from repro.estimators import StencilOperator as JaxStencil
from repro.kernels import autotune as jtune

import repro_torch
from repro_torch.core import calibration as tcal
from repro_torch.core import configs
from repro_torch.core.mesh import Mesh
from repro_torch.core.plan import ProblemSpec, select_method, select_route
from repro_torch.core.plan import spec_of
from repro_torch.estimators import StencilOperator
from repro_torch.kernels import autotune as ttune

ROOT = Path(__file__).resolve().parents[1]
JAX_TABLE = ROOT / "bench_out" / "roofline_calibration.json"
SYNTHETIC = dict(gemm_flops=3.0e13, stream_bytes=3.0e12,
                 collective_lat=1.5e-5, collective_bytes=5.0e10,
                 gemm_flops_bf16=6.0e13, source="synthetic")
TABLES = ("static", "jax_cpu", "synthetic")
NS = (16, 24, 63, 100, 128, 257, 1000, 2048, 4096, 8192, 10000, 16384,
      32768, 65536)
DEVICES = (1, 2, 4, 8)


def _tables(name):
    """(JAX calibration, port calibration) of one table."""
    if name == "static":
        return jcal.STATIC_DEFAULT, tcal.STATIC_DEFAULT
    if name == "jax_cpu":
        return (jcal.load_calibration(JAX_TABLE),
                tcal.load_calibration(JAX_TABLE))
    return jcal.Calibration(**SYNTHETIC), tcal.Calibration(**SYNTHETIC)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No override from the environment, and no cached model results."""
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION", raising=False)
    ttune.clear_autotune_cache()
    tcal.clear_calibration_cache()
    yield
    ttune.clear_autotune_cache()
    tcal.clear_calibration_cache()


def _specs(n, batch, devices, dtype="float32"):
    kw = dict(kind="dense" if batch is None else "batched", n=n, batch=batch,
              dtype=dtype, structure="dense", matvec_flops=2.0 * n * n,
              materializable=True, device_count=devices)
    return JaxSpec(**kw), ProblemSpec(**kw)


def _route(r):
    method, cfg = r
    if cfg is None:
        return method, None
    return method, (cfg.schedule, cfg.update, cfg.panel_k, cfg.lookahead,
                    cfg.precision)


@pytest.mark.parametrize("table", TABLES)
def test_port_table_reads_as_the_jax_table(table):
    jc, tc = _tables(table)
    for f in dataclasses.fields(jc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.host_rank1_row_s == tc.host_panel_row_s == 0.0


@pytest.mark.parametrize("precision", [None, "bf16"])
@pytest.mark.parametrize("devices", DEVICES)
@pytest.mark.parametrize("table", TABLES)
def test_select_route_matches_jax(table, devices, precision):
    jc, tc = _tables(table)
    for n in NS:
        for batch in (None, 3):
            for dtype in ("float32", "float64"):
                js, ts = _specs(n, batch, devices, dtype)
                for rtol in (None, 1e-6, 1e-2):
                    for bounds_known in (False, True):
                        for est_cols in (None, 64 * 8):
                            kw = dict(rtol=rtol, bounds_known=bounds_known,
                                      est_cols=est_cols, precision=precision)
                            want = _route(jax_select_route(
                                js, calibration=jc, **kw))
                            got = _route(select_route(ts, calibration=tc,
                                                      **kw))
                            assert got == want, (n, batch, dtype, kw)


@pytest.mark.parametrize("devices", DEVICES)
@pytest.mark.parametrize("table", TABLES)
def test_select_method_matches_jax_with_a_mesh(table, devices):
    """A port `Mesh` of P ranks sets the device count as a JAX mesh of P
    devices does; operators go to an estimator whatever the table."""
    jc, tc = _tables(table)
    mesh = Mesh(group=None, size=devices, rank=0, device=torch.device("cpu"))
    for n in NS:
        js, ts = _specs(n, None, devices)
        _, ts1 = _specs(n, None, 1)
        for rtol in (None, 1e-6):
            want = jax_select_method(js, rtol=rtol, calibration=jc)
            assert select_method(ts, rtol=rtol, calibration=tc) == want
            assert select_method(ts1, mesh=mesh, rtol=rtol,
                                 calibration=tc) == want
        op = dataclasses.replace(ts, kind="operator", structure="stencil",
                                 matvec_flops=10.0 * n, materializable=False)
        jop = dataclasses.replace(js, kind="operator", structure="stencil",
                                  matvec_flops=10.0 * n,
                                  materializable=False)
        for bk in (False, True):
            assert select_route(op, bounds_known=bk, calibration=tc) == \
                jax_select_route(jop, bounds_known=bk, calibration=jc)


@pytest.mark.parametrize("table", TABLES)
def test_resolved_panel_k_matches_jax(table):
    jc, tc = _tables(table)
    for n in NS + (1, 2, 8, 33):
        for itemsize in (4, 8):
            for precision in (None, "bf16"):
                kw = dict(itemsize=itemsize, precision=precision)
                assert ttune.resolved_panel_k(n, cal=tc, **kw) == \
                    jtune.resolved_panel_k(n, cal=jc, **kw), (n, kw)


@pytest.mark.parametrize("table", TABLES)
def test_exact_and_estimator_cost_match_jax(table):
    jc, tc = _tables(table)
    for n in NS + (0, 1):
        for devices in DEVICES:
            for batch in (1, 3):
                for itemsize in (4, 8):
                    for update in ("rank1", "panel"):
                        for la in (False, True):
                            for precision in (None, "bf16"):
                                for k in (None, 32):
                                    kw = dict(update=update, panel_k=k,
                                              itemsize=itemsize, batch=batch,
                                              lookahead=la,
                                              precision=precision)
                                    assert tcal.exact_cost(
                                        n, devices, tc, **kw) == \
                                        jcal.exact_cost(n, devices, jc, **kw)
                    for cols in (1, 66, 866):
                        kw = dict(itemsize=itemsize, batch=batch)
                        assert tcal.estimator_cost(
                            n, cols, 2.0 * n * n, devices, tc, **kw) == \
                            jcal.estimator_cost(n, cols, 2.0 * n * n,
                                                devices, jc, **kw)


def _crossover(cal):
    """The smallest n at which dense SPD f32 input leaves the exact
    family under ``cal``."""
    for n in range(16, 70000, 16):
        if select_method(ProblemSpec("dense", n, None, "float32",
                                     matvec_flops=2.0 * n * n),
                         calibration=cal) != "exact":
            return n
    return None


def test_host_terms_move_the_crossover_not_the_width():
    """Host dispatch per row (H100-like figures) moves dense SPD input to
    slq at a far smaller n, adds exactly n times the route's term to
    every exact cost (mesh routes included; once for a whole stack, whose
    steps run all its matrices at once), and leaves the panel width
    alone."""
    base = tcal.Calibration(**SYNTHETIC)
    host = dataclasses.replace(base, host_rank1_row_s=4e-4,
                               host_panel_row_s=5e-5)
    plain, moved = _crossover(base), _crossover(host)
    assert moved is not None and plain is not None and moved < plain / 2
    for n in NS:
        assert ttune.resolved_panel_k(n, cal=host) == \
            ttune.resolved_panel_k(n, cal=base)
        for devices in (1, 4):
            for update, term in (("rank1", 4e-4), ("panel", 5e-5)):
                for batch in (1, 3):
                    kw = dict(update=update, panel_k=32, itemsize=4,
                              batch=batch)
                    np.testing.assert_allclose(
                        tcal.exact_cost(n, devices, host, **kw)
                        - tcal.exact_cost(n, devices, base, **kw),
                        n * term, rtol=1e-9)
    # at the exact cell, the host terms make panel the exact route and
    # slq the estimator choice (the JAX model alone picks exact there)
    spec = ProblemSpec("dense", 8192, None, "float32",
                       matvec_flops=2.0 * 8192 ** 2)
    assert select_method(spec, calibration=base) == "exact"
    assert select_method(spec, calibration=host) == "slq"
    assert select_route(spec, rtol=1e-6, calibration=host)[1].update == \
        "panel"


def test_calibration_validates_and_loads(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="host_panel_row_s"):
        tcal.Calibration(host_panel_row_s=-1.0)
    with pytest.raises(ValueError, match="gemm_flops"):
        tcal.Calibration(gemm_flops=0.0)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({**SYNTHETIC, "host_rank1_row_s": 1e-4,
                                "host_panel_row_s": 2e-5}))
    cal = tcal.load_calibration(path)
    assert (cal.host_rank1_row_s, cal.host_panel_row_s) == (1e-4, 2e-5)
    assert cal.host_row_s("rank1") == 1e-4 and cal.host_row_s("panel") == 2e-5
    # the search order: the variable's path, "static", then the committed
    # table; the JAX package's table only when its path is passed
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(path))
    assert tcal.calibration_path() == path
    assert tcal.load_calibration() == cal
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", "static")
    assert tcal.calibration_path() is None
    assert tcal.load_calibration() is tcal.STATIC_DEFAULT
    monkeypatch.delenv("REPRO_TORCH_CALIBRATION")
    committed = ROOT / "bench_out" / "torch_roofline_calibration.json"
    assert tcal.calibration_path() == (committed if committed.exists()
                                       else None)
    assert tcal.calibration_path() != JAX_TABLE
    bad = tmp_path / "bad.json"
    bad.write_text("{")
    with pytest.raises(ValueError, match="cannot read"):
        tcal.load_calibration(bad)


def test_committed_table_is_the_cards():
    """The committed table was measured on a card: every term positive,
    the host terms included."""
    committed = ROOT / "bench_out" / "torch_roofline_calibration.json"
    cal = tcal.load_calibration(committed)
    assert cal.source.startswith("measured:cuda")
    for f in ("gemm_flops", "stream_bytes", "collective_lat",
              "collective_bytes", "gemm_flops_bf16", "host_rank1_row_s",
              "host_panel_row_s"):
        assert getattr(cal, f) > 0, f
    meta = json.loads(committed.read_text())["meta"]
    assert "nvidia_smi" in meta and "torch" in meta


@pytest.mark.parametrize("env", [
    "", "off", "OFF ", "panel_k=64", "panel_k=64,block_m=128,block_n=256",
    " panel_k = 16 ", "block_m=8", "bad", "foo=1", "panel_k=0",
    "panel_k=x", "panel_k=64,"])
def test_autotune_override_parses_as_jax(env, monkeypatch):
    def parse(mod):
        try:
            cfg = mod._parse_override(env)
        except (ValueError, TypeError) as e:
            return type(e)
        return None if cfg is None else (cfg.panel_k, cfg.source)

    assert parse(ttune) == parse(jtune)
    want = parse(jtune)
    if want is not None and not isinstance(want, type):
        monkeypatch.setenv("REPRO_AUTOTUNE", env)
        assert ttune.resolved_panel_k(4096) == jtune.resolved_panel_k(4096) \
            == want[0]


def test_tile_config_reports_k2_tiles():
    """block_m / block_n are K2's output tiles for the dtypes (the
    `Config<T, OpT>` lines of csrc/panel_update.cu), not the TPU's."""
    cal = tcal.STATIC_DEFAULT
    assert (ttune.tile_config(8192, itemsize=4, cal=cal).block_m,
            ttune.tile_config(8192, itemsize=4, cal=cal).block_n) == (64, 128)
    cfg = ttune.tile_config(8192, itemsize=4, precision="bf16", cal=cal)
    assert (cfg.block_m, cfg.block_n) == (128, 128)
    cfg = ttune.tile_config(8192, itemsize=8, cal=cal)
    assert (cfg.block_m, cfg.block_n) == (64, 64)
    assert cfg.source == "model:static-default"
    if not torch.cuda.is_available():
        assert ttune.device_fingerprint() == "cpu"
    # the cached path (no table passed) equals the model on the loaded one
    assert ttune.tile_config(8192) == ttune.tile_config(
        8192, cal=tcal.load_calibration())


def test_operator_spec_matches_jax():
    """`spec_of` an operator carries its hints' materializability and
    device count, as the JAX package's does."""
    side = 5
    n = side * side
    bands = np.ones((5, n))
    offsets = (-side, -1, 0, 1, side)
    got = spec_of(StencilOperator(offsets, torch.from_numpy(bands)))
    want = jax_spec_of(JaxStencil(offsets, np.asarray(bands)))
    for f in ("kind", "n", "structure", "matvec_flops", "materializable",
              "device_count"):
        assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------------------ auto plans

def _matrix(n, seed=3, spd=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    a = x @ x.T / (2 * n) + np.eye(n)
    if not spd:
        a[1] = -a[1]
    return a


@pytest.mark.parametrize("n,kw", [(20, {}), (100, {}), (300, {}),
                                  (100, {"rtol": 1e-6, "num_probes": 4}),
                                  (64, {"precision": "bf16"}),
                                  (130, {"precision": "float64"})])
def test_auto_plans_run_the_selected_route(n, kw, monkeypatch):
    """With the static table every dense input here resolves to exact:
    the plan runs the route and panel width `select_route` names, the
    estimator knobs are dropped, and the result is numpy's."""
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", "static")
    a = _matrix(n)
    prec = kw.get("precision")
    spec = spec_of(a, dtype=None if prec == "bf16" else prec)
    method, route = select_route(
        spec, rtol=kw.get("rtol"),
        precision="bf16" if prec == "bf16" else None)
    p = repro_torch.plan(a, device="cpu", **kw)
    assert p.method == method == "exact"
    assert (p.config.schedule, p.config.update, p.config.k,
            p.config.precision) == (route.schedule, route.update,
                                    route.panel_k, route.precision)
    res = p()
    s_np, ld_np = np.linalg.slogdet(a)
    assert float(res.sign) == s_np
    tol = 5e-3 if prec == "bf16" else 1e-6
    assert abs(float(res.logabsdet) - ld_np) <= tol * abs(ld_np)


def test_auto_picks_the_estimators_where_the_table_says(tmp_path,
                                                        monkeypatch):
    """Under a table whose host terms make exact slow, SPD input goes to
    slq, to chebyshev with bounds, and exact knobs are dropped; an
    operator goes to an estimator whatever the table; rtol below 1e-3
    keeps exact."""
    path = tmp_path / "slow_host.json"
    path.write_text(json.dumps({**SYNTHETIC, "host_rank1_row_s": 1e-2,
                                "host_panel_row_s": 1e-2}))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION", str(path))
    a = _matrix(64, spd=True)
    p = repro_torch.plan(a, device="cpu", k=8, num_probes=8, num_steps=10)
    assert p.method == "slq" and p.config.num_probes == 8
    s_np, ld_np = np.linalg.slogdet(a)
    res = p()
    assert abs(float(res.logabsdet) - ld_np) <= 5 * float(res.sem) + 1e-3
    ev = np.linalg.eigvalsh(a)
    p = repro_torch.plan(a, device="cpu", lmin=0.9 * ev[0],
                         lmax=1.1 * ev[-1], num_probes=8)
    assert p.method == "chebyshev"
    res = p()
    assert abs(float(res.logabsdet) - ld_np) <= 5 * float(res.sem) + 1e-3
    assert repro_torch.plan(a, device="cpu", rtol=1e-6).method == "exact"
    side = 4
    bands = np.ones((3, side)) * np.array([[-1.0], [4.0], [-1.0]])
    op = StencilOperator((-1, 0, 1), torch.from_numpy(bands))
    assert repro_torch.plan(op, device="cpu").method == "slq"


def test_auto_rejections():
    a = _matrix(16)
    with pytest.raises(ValueError, match="ambiguous"):
        repro_torch.plan(a, config=configs.ExactConfig(), device="cpu")
    with pytest.raises(TypeError, match="unknown keywords"):
        repro_torch.plan(a, warp=2, device="cpu")
    assert configs.filter_for_method("slq", {"k": 8, "num_steps": 3}) == {
        "num_steps": 3}
    assert configs.filter_for_method("exact", {"k": 8, "degree": 3}) == {
        "k": 8}
    assert configs.filter_for_method("plu", {"nb": 4, "seed": 1}) == {
        "nb": 4}
