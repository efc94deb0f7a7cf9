"""The port's mesh schedule and `ShardedOperator` on the CPU, against the
JAX package.

The ranks are processes (`repro_torch.core.mesh.run_ranks`, gloo, one
spawn per mesh size P = 1, 2, 4); their work is in tests/test_torch_ranks.py.
The JAX references: P = 1 in this process on the ``mesh1`` fixture, P = 2
and P = 4 in a subprocess with that many fake devices
(tests/_subproc.py), with the ``xla`` backend (the Pallas kernels'
plain references).

Tolerances, as in tests/test_torch_engine.py: sign exact; log|det| rtol
1e-10 in f64, 1e-4 in f32, 1e-5 for ``near_singular`` (f64 only: in f32
that matrix is numerically singular), 5e-3 with bf16 operands (against
numpy's slogdet: the documented bf16 error model).  The sharded estimators on
identical probes and bounds: f64 rtol 1e-10, the JAX package's own
sharded-against-dense tolerance (tests/test_estimators.py:125).  Within
the port: lookahead bitwise equal to the plain schedule, and every rank
returns the same result bit for bit.  A matrix with a NaN entry (P = 1,
2) gives sign NaN and log|det| NaN in both packages.
"""
import functools
import json
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro._compat import make_mesh
from repro.core import pad_to_multiple as jax_pad
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import build_mesh as jax_build_mesh
from repro.estimators import ShardedOperator as JaxShardedOperator
from repro.estimators import logdet_chebyshev as jax_chebyshev
from repro.estimators import logdet_slq as jax_slq

import test_torch_ranks as ranks
from _subproc import SRC, run_with_devices

from repro_torch import estimators as est
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.mesh import run_ranks

SIZES = (1, 2, 4)
PANEL_K = ranks.PANEL_K
SPAWN_TIMEOUT = 300
EST_N, DEGREE, NUM_STEPS = 64, 24, 16


def _cases():
    """The inputs of tests/test_engine.py:25-42, made the same way."""
    rng = np.random.default_rng(42)
    cases = {}
    cases["random"] = rng.standard_normal((48, 48))
    cases["scaled_odd"] = rng.standard_normal((37, 37)) * 1e6
    cases["permutation"] = np.eye(41)[rng.permutation(41)]
    spd = rng.standard_normal((32, 64))
    spd = spd @ spd.T / 64 + 2.0 * np.eye(32)
    neg = spd.copy()
    neg[3] = -neg[3]
    cases["negative_det"] = neg
    b = rng.standard_normal((24, 4))
    cases["near_singular"] = b @ b.T + 1e-10 * np.eye(24)
    return cases


CASES = _cases()
# a Gaussian matrix with one NaN entry, run by the mesh sizes NAN_SIZES
NAN_CASE = np.random.default_rng(0).standard_normal((40, 40))
NAN_CASE[5, 7] = np.nan
NAN_SIZES = (1, 2)
ROUTES = [(c, d) for d in ("float32", "float64") for c in sorted(CASES)
          if not (d == "float32" and c == "near_singular")]


def _spd(n, seed):
    x = np.random.default_rng(seed).standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + np.eye(n)


def _est_inputs():
    a = _spd(EST_N, 7)
    probes = np.random.default_rng(8).choice([-1.0, 1.0], size=(EST_N, 8))
    v = np.random.default_rng(9).standard_normal((EST_N, 3))
    ev = np.linalg.eigvalsh(a)
    return dict(a=a, probes=probes, bounds=(0.9 * ev[0], 1.1 * ev[-1]), v=v,
                degree=DEGREE, num_steps=NUM_STEPS)


EST = _est_inputs()
# plan inputs whose side (30) no mesh size of 4 divides: padded to 32
PLAN_EXACT = np.random.default_rng(11).standard_normal((30, 30))
PLAN_SPD = _spd(30, 12)
PLAN_PROBES = np.random.default_rng(13).choice([-1.0, 1.0], size=(32, 4))
PLAN_BOUNDS = tuple(float(b) for b in (0.9 * np.linalg.eigvalsh(PLAN_SPD)[0],
                                       1.1 * np.linalg.eigvalsh(PLAN_SPD)[-1]))


@functools.lru_cache(maxsize=None)
def _port(size: int):
    """Every rank's result for mesh size ``size`` (one spawn)."""
    payload = {"cases": CASES, "bf16_case": "negative_det",
               "plans": dict(a_exact=PLAN_EXACT, a_spd=PLAN_SPD,
                             probes=PLAN_PROBES, bounds=PLAN_BOUNDS)}
    if size != 2:
        payload["sharded"] = EST
    if size in NAN_SIZES:
        payload["nan"] = {"nan": NAN_CASE}
    return run_ranks(ranks.everything, size, backend="gloo", device="cpu",
                     timeout=SPAWN_TIMEOUT, args=(payload,))


_JAX_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro._compat import make_mesh
from repro.core import pad_to_multiple
from repro.core.engine import EngineConfig, build_mesh
from repro.estimators import ShardedOperator, logdet_chebyshev, logdet_slq
data = np.load({path!r})
size = {size}
mesh = make_mesh((size,), ("rows",))
out = {{}}
for key in data.files:
    if not key.startswith("case|"):
        continue
    _, case, dtype = key.split("|")
    a = pad_to_multiple(jnp.asarray(data[key]), size)
    for update in ("rank1", "panel"):
        cfg = EngineConfig(schedule="mesh", update=update, panel_k={k},
                           backend="xla")
        s, ld = build_mesh(cfg, mesh)(a)
        out["|".join((case, dtype, update))] = [float(s), float(ld)]
if "est_a" in data.files:
    op = ShardedOperator(jnp.asarray(data["est_a"]), mesh)
    probes = jnp.asarray(data["est_probes"])
    lo, hi = (float(b) for b in data["est_bounds"])
    c = logdet_chebyshev(op, probes=probes, lmin=lo, lmax=hi,
                         degree={degree})
    s = logdet_slq(op, probes=probes, num_steps={steps})
    out["cheb"] = [float(c.est), float(c.sem)]
    out["slq"] = [float(s.est), float(s.sem)]
print(json.dumps(out))
"""


def _jax_inputs(path, with_est: bool, with_nan: bool):
    arrays = {f"case|{c}|{d}": CASES[c].astype(d) for c, d in ROUTES}
    if with_nan:
        arrays.update({f"case|nan|{d}": NAN_CASE.astype(d)
                       for d in ("float32", "float64")})
    if with_est:
        arrays.update(est_a=EST["a"], est_probes=EST["probes"],
                      est_bounds=np.asarray(EST["bounds"]))
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """``{size: {route or estimator: values}}`` of the JAX package."""
    mesh1 = make_mesh((1,), ("rows",))       # the mesh1 fixture's mesh
    refs = {1: {}}
    nan_routes = [("nan", d) for d in ("float32", "float64")]
    for case, dtype in ROUTES + nan_routes:
        src = NAN_CASE if case == "nan" else CASES[case]
        a = jax_pad(jnp.asarray(src.astype(dtype)), 1)
        for update in ("rank1", "panel"):
            cfg = JaxEngineConfig(schedule="mesh", update=update,
                                  panel_k=PANEL_K, backend="xla")
            s, ld = jax_build_mesh(cfg, mesh1)(a)
            refs[1][f"{case}|{dtype}|{update}"] = [float(s), float(ld)]
    op = JaxShardedOperator(jnp.asarray(EST["a"]), mesh1)
    probes = jnp.asarray(EST["probes"])
    c = jax_chebyshev(op, probes=probes, lmin=EST["bounds"][0],
                      lmax=EST["bounds"][1], degree=DEGREE)
    s = jax_slq(op, probes=probes, num_steps=NUM_STEPS)
    refs[1]["cheb"] = [float(c.est), float(c.sem)]
    refs[1]["slq"] = [float(s.est), float(s.sem)]
    for size in (2, 4):
        path = str(tmp_path_factory.mktemp("jax_mesh") / f"p{size}.npz")
        _jax_inputs(path, with_est=size == 4, with_nan=size in NAN_SIZES)
        code = _JAX_CODE.format(src=SRC, path=path, size=size, k=PANEL_K,
                                degree=DEGREE, steps=NUM_STEPS)
        stdout = run_with_devices(code, size, timeout=SPAWN_TIMEOUT)
        refs[size] = json.loads(stdout.strip().splitlines()[-1])
    return refs


def _rtol(case, dtype):
    if dtype == "float32":
        return 1e-4
    return 1e-5 if case == "near_singular" else 1e-10


# ------------------------------------------------------------- exact path

@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("case,dtype", ROUTES)
@pytest.mark.parametrize("size", SIZES)
def test_mesh_matches_jax(jax_refs, size, case, dtype, update):
    s, ld = _port(size)[0]["exact"][f"{case}|{dtype}|{update}|0"]
    s_ref, ld_ref = jax_refs[size][f"{case}|{dtype}|{update}"]
    assert s == s_ref, (s, s_ref)
    np.testing.assert_allclose(ld, ld_ref, rtol=_rtol(case, dtype),
                               atol=1e-8)
    # and against numpy's f64 slogdet of the unpadded input
    s_np, ld_np = np.linalg.slogdet(CASES[case])
    assert s == s_np
    np.testing.assert_allclose(ld, ld_np, rtol=_rtol(case, dtype), atol=1e-8)


@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("size", SIZES)
def test_lookahead_is_bitwise_plain(size, update):
    exact = _port(size)[0]["exact"]
    for case, dtype in ROUTES:
        plain = exact[f"{case}|{dtype}|{update}|0"]
        assert exact[f"{case}|{dtype}|{update}|1"] == plain, (case, dtype)


@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("size", NAN_SIZES)
def test_mesh_nan_entry_gives_a_nan_sign(jax_refs, size, dtype, update):
    """Plain and lookahead; in the JAX package too.  The partial signs
    reach the result through `mesh_tail`'s all_reduce and product."""
    s_ref, ld_ref = jax_refs[size][f"nan|{dtype}|{update}"]
    assert math.isnan(s_ref) and math.isnan(ld_ref)
    got = _port(size)[0]["nan"]
    for la in (0, 1):
        s, ld = got[f"nan|{dtype}|{update}|{la}"]
        assert math.isnan(s) and math.isnan(ld), (la, s, ld)


@pytest.mark.parametrize("size", SIZES)
def test_mesh_bf16_operands(size):
    """bf16 multiply operands on the mesh: within the 5e-3 bf16 error
    model of numpy's f64 slogdet (tests/test_engine.py:384), sign exact,
    lookahead bitwise equal to plain."""
    exact = _port(size)[0]["exact"]
    s_np, ld_np = np.linalg.slogdet(CASES["negative_det"])
    for update in ("rank1", "panel"):
        s, ld = exact[f"negative_det|float32|{update}|0|bf16"]
        assert s == s_np
        assert abs(ld - ld_np) <= 5e-3 * abs(ld_np)
        assert exact[f"negative_det|float32|{update}|1|bf16"] == (s, ld)


def _same(x, y):
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, np.ndarray):
        return np.array_equal(x, y)
    if isinstance(x, (tuple, list)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, float) and isinstance(y, float):
        return x == y or (math.isnan(x) and math.isnan(y))
    return x == y


@pytest.mark.parametrize("size", SIZES)
def test_every_rank_returns_the_same_result(size):
    results = _port(size)
    assert len(results) == size
    for r, res in enumerate(results[1:], 1):
        assert _same(res, results[0]), f"rank {r} differs from rank 0"


# ------------------------------------------------------ ShardedOperator

@pytest.mark.parametrize("size", [1, 4])
def test_sharded_operator_products(size):
    got = _port(size)[0]["sharded"]
    a, v = EST["a"], EST["v"]
    np.testing.assert_allclose(got["mm"], a @ v, rtol=1e-12)
    np.testing.assert_allclose(got["mv"], a @ v[:, 0], rtol=1e-12)
    np.testing.assert_allclose(got["rmm"], a.T @ v, rtol=1e-12)
    np.testing.assert_array_equal(got["diag"], np.diagonal(a))
    np.testing.assert_allclose(got["trace"], np.trace(a), rtol=1e-14)
    np.testing.assert_array_equal(got["dense"], a)
    assert got["local_rows"] == EST_N // size
    assert got["hints"] == ("sharded", 2.0 * EST_N ** 2 / size, True, size)


@pytest.mark.parametrize("method", ["cheb", "slq"])
@pytest.mark.parametrize("size", [1, 4])
def test_sharded_estimators_match_jax(jax_refs, size, method):
    est_v, sem = _port(size)[0]["sharded"][method]
    ref_v, ref_sem = jax_refs[size][method]
    np.testing.assert_allclose(est_v, ref_v, rtol=1e-10)
    np.testing.assert_allclose(sem, ref_sem, rtol=1e-8)


@pytest.mark.parametrize("size", [1, 4])
def test_sharded_cg_solves(size):
    got = _port(size)[0]["sharded"]
    assert got["cg_converged"] and 0 < got["cg_iters"] <= EST_N
    np.testing.assert_allclose(got["cg_x"],
                               np.linalg.solve(EST["a"], EST["v"]),
                               rtol=1e-9, atol=1e-11)


# ----------------------------------------------------------------- plans

@pytest.mark.parametrize("size", SIZES)
def test_mesh_plans(size):
    got = _port(size)[0]["plans"]
    padded = -(-30 // size) * size
    s_np, ld_np = np.linalg.slogdet(PLAN_EXACT)
    for update in ("rank1", "panel"):
        schedule, padded_n, devices, (s, ld), device = got[f"exact|{update}"]
        assert (schedule, padded_n, devices, device) == (
            "mesh", padded, size, "cpu")
        assert s == s_np
        np.testing.assert_allclose(ld, ld_np, rtol=1e-10)
    schedule, devices, (s, ld) = got["exact|staged"]
    assert (schedule, devices, s) == ("staged", 1, s_np)
    np.testing.assert_allclose(ld, ld_np, rtol=1e-10)
    # the estimators run a ShardedOperator of diag(A, I), the Chebyshev
    # bounds widened to bracket the padding's unit eigenvalues: the same
    # estimate as the dense operator of the padded matrix
    a = pad_to_multiple(torch.from_numpy(PLAN_SPD), size)
    probes = torch.from_numpy(PLAN_PROBES[:padded])
    lo, hi = PLAN_BOUNDS
    if padded != 30:
        lo, hi = min(lo, 1.0), max(hi, 1.0)
    want = {"chebyshev": est.logdet_chebyshev(a, probes=probes, lmin=lo,
                                              lmax=hi, degree=16,
                                              device="cpu"),
            "slq": est.logdet_slq(a, probes=probes, num_steps=12,
                                  device="cpu")}
    for method, res in want.items():
        padded_n, devices, value, sem = got[method]
        assert (padded_n, devices) == (padded, size)
        np.testing.assert_allclose(value, float(res.est), rtol=1e-10)
    assert np.isfinite(got["chebyshev|seeded"])
    assert got["rejected"] == {"fused": "ValueError", "batched": "TypeError",
                               "operator": "TypeError"}
