"""repro_torch's condensation engine (`build_serial` on CPU tensors)
against `repro.core.engine.engine_slogdet` with the Pallas kernels in
interpret mode, on the adversarial inputs of tests/test_engine.py.

Sign exact everywhere.  log|det| tolerances, with their reasons:

* f64 rtol 1e-10: the frameworks differ only in FMA contraction, the
  triangular solve and the GEMM's summation order (about 1e-14 here);
* f32 rtol 1e-4: the same differences at f32 precision, carried through
  up to 48 dependent elimination steps;
* ``near_singular`` (condition ~1e10) rtol 1e-5 in f64, as
  tests/test_engine.py:50 allows against LAPACK; in f32 its 1e-10 ridge
  is below the f32 resolution of the O(1) entries, so the f32 matrix is
  numerically singular and its last pivots are rounding noise: the case
  is checked in f64 only (and so not with bf16 operands on f32 either);
* bf16 operands (panel route): rel 5e-3, the documented bf16 error model
  (tests/test_engine.py:384).  The reference is the JAX engine on its
  ``xla`` backend: under jax 0.9 the interpret-mode kernel cannot run a
  bf16 x bf16 -> f32 dot on the CPU inside the engine's jit.  That
  backend's jnp oracle rounds the GEMM product to bf16, while the port
  follows the Pallas kernel and accumulates in f32, so the two differ by
  bf16 roundings -- inside the error model, which the port also meets
  against numpy's f64 slogdet.

Within the port, fused and unfused routes agree bit for bit, as the JAX
package asserts for its own (tests/test_engine.py:351).

A matrix with a NaN entry gives sign NaN and log|det| NaN in both
packages on every exact route: never the sign 0 that reads as a singular
matrix (``torch.sign(nan)`` is 0, ``jnp.sign(nan)`` NaN).
"""
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro
import repro_torch

from repro.core import pad_to_multiple as jax_pad
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import engine_slogdet, stage_schedule as jax_schedule

from repro_torch.core import engine
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.engine import EngineConfig, build_serial
from repro_torch.core.mesh import Mesh

PANEL_K, MIN_SIZE = 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These matrices are small: intra-op threads gain nothing and would
    crowd the other test processes sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@functools.lru_cache(maxsize=None)
def _jax_ref(case, schedule, update, dtype, precision):
    """(sign, logabsdet) of the JAX engine, unfused, interpret backend
    (xla for bf16 operands, see the module docstring)."""
    a = jnp.asarray(CASES[case], DTYPES[dtype][0])
    if update == "panel":
        a = jax_pad(a, PANEL_K)
    cfg = JaxEngineConfig(schedule=schedule, update=update, panel_k=PANEL_K,
                          min_size=MIN_SIZE,
                          backend="xla" if precision else "interpret",
                          precision=precision)
    s, ld = engine_slogdet(a, cfg)
    return float(s), float(ld)


def _port(case, schedule, update, dtype, fused, precision=None):
    a = torch.from_numpy(CASES[case]).to(DTYPES[dtype][1])
    if update == "panel":
        a = pad_to_multiple(a, PANEL_K)
    cfg = EngineConfig(schedule=schedule, update=update, panel_k=PANEL_K,
                       min_size=MIN_SIZE, fused=fused, precision=precision)
    return build_serial(cfg)(a)


def _rtol(case, dtype):
    if dtype == "float32":
        return 1e-4
    return 1e-5 if case == "near_singular" else 1e-10


def _cases_for(dtype):
    return [c for c in sorted(CASES)
            if not (dtype == "float32" and c == "near_singular")]


@pytest.mark.parametrize("case,dtype",
                         [(c, d) for d in DTYPES for c in _cases_for(d)])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("schedule", ["serial", "staged"])
def test_engine_matches_jax(schedule, update, fused, case, dtype):
    s_ref, ld_ref = _jax_ref(case, schedule, update, dtype, None)
    s, ld = _port(case, schedule, update, dtype, fused)
    assert s.dtype == ld.dtype == DTYPES[dtype][1]
    assert float(s) == s_ref, (float(s), s_ref)
    np.testing.assert_allclose(float(ld), ld_ref, rtol=_rtol(case, dtype),
                               atol=1e-8)
    if fused:
        s0, ld0 = _port(case, schedule, update, dtype, False)
        assert torch.equal(s, s0) and torch.equal(ld, ld0), \
            (float(ld), float(ld0))


@pytest.mark.parametrize("case", _cases_for("float32"))
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", ["serial", "staged"])
def test_engine_bf16_panel_matches_jax(schedule, fused, case):
    s_ref, ld_ref = _jax_ref(case, schedule, "panel", "float32", "bf16")
    s, ld = _port(case, schedule, "panel", "float32", fused, "bf16")
    assert s.dtype == torch.float32
    assert float(s) == s_ref
    assert abs(float(ld) - ld_ref) <= 5e-3 * max(abs(ld_ref), 1.0)
    s_np, ld_np = np.linalg.slogdet(CASES[case])
    assert float(s) == s_np
    assert abs(float(ld) - ld_np) <= 5e-3 * max(abs(ld_np), 1.0)
    if fused:
        s0, ld0 = _port(case, schedule, "panel", "float32", False, "bf16")
        assert torch.equal(s, s0) and torch.equal(ld, ld0)


@pytest.mark.parametrize("update", ["rank1", "panel"])
def test_engine_leaves_the_input_alone(update, rng):
    a = torch.from_numpy(rng.standard_normal((40, 40)))
    before = a.clone()
    cfg = EngineConfig(schedule="staged", update=update, panel_k=8,
                       min_size=16)
    build_serial(cfg)(a)
    build_serial(EngineConfig(schedule="serial", update=update, panel_k=8,
                              fused=True))(a)
    assert torch.equal(a, before)


@pytest.mark.parametrize("n", [2, 64, 65, 200, 8192])
def test_stage_schedule_matches_jax(n):
    assert engine.stage_schedule(n, 0.75, 64) == jax_schedule(n, 0.75, 64)


def test_engine_tiny_inputs():
    one = torch.tensor([[-3.0]], dtype=torch.float64)
    s, ld = engine.condense_full(one)
    assert float(s) == -1.0 and float(ld) == pytest.approx(np.log(3.0))
    s, ld = engine.condense_full(torch.zeros((0, 0)))
    assert float(s) == 1.0 and float(ld) == 0.0


def test_engine_config_validation():
    with pytest.raises(ValueError, match="schedule"):
        EngineConfig(schedule="spiral")
    with pytest.raises(ValueError, match="update"):
        EngineConfig(update="rank3")
    with pytest.raises(ValueError, match="backend"):
        EngineConfig(backend="xla")
    with pytest.raises(ValueError, match="shrink"):
        EngineConfig(shrink=1.5)
    with pytest.raises(ValueError, match="lookahead"):
        EngineConfig(schedule="staged", lookahead=True)
    with pytest.raises(ValueError, match="fused"):
        EngineConfig(schedule="mesh", fused=True)
    with pytest.raises(ValueError, match="precision"):
        EngineConfig(precision="fp8")


def test_mesh_schedule_needs_build_mesh_and_a_mesh():
    """As in the JAX package: `build_serial` rejects the mesh schedule,
    `engine_slogdet` needs a mesh for it, and `build_mesh` needs it (the
    mesh routes themselves run in tests/test_torch_mesh.py)."""
    mesh = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="build_mesh"):
        build_serial(EngineConfig(schedule="mesh"))
    with pytest.raises(ValueError, match="build_mesh"):
        build_serial(EngineConfig(schedule="mesh", lookahead=True))
    with pytest.raises(ValueError, match="requires a mesh"):
        engine.engine_slogdet(torch.eye(4), EngineConfig(schedule="mesh"))
    with pytest.raises(ValueError, match="schedule='mesh'"):
        engine.build_mesh(EngineConfig(schedule="staged"), mesh)
    run = engine.build_mesh(EngineConfig(schedule="mesh"), mesh)
    with pytest.raises(ValueError, match="square"):
        run(torch.zeros(4, 3))


def test_shared_sign_helpers():
    s, ld = engine.combine_slogdet([(torch.tensor(-1.0), torch.tensor(2.0)),
                                    (torch.tensor(-1.0), torch.tensor(0.5))])
    assert float(s) == 1.0 and float(ld) == 2.5
    p = torch.tensor([0.0, 2.0])
    assert engine.guarded_pivot(p).tolist() == [1.0, 2.0]


def _nan_matrix():
    """A 40 x 40 Gaussian matrix with one NaN entry."""
    a = np.random.default_rng(0).standard_normal((40, 40))
    a[5, 7] = np.nan
    return a


NAN_A = _nan_matrix()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("schedule", ["serial", "staged"])
def test_engine_nan_entry_gives_a_nan_sign(schedule, update, fused, dtype):
    np_dt, t_dt = DTYPES[dtype]
    cfg = dict(schedule=schedule, update=update, panel_k=PANEL_K,
               min_size=MIN_SIZE, fused=fused)
    s_ref, ld_ref = engine_slogdet(jnp.asarray(NAN_A, np_dt),
                                   JaxEngineConfig(backend="interpret", **cfg))
    s, ld = build_serial(EngineConfig(**cfg))(torch.from_numpy(NAN_A)
                                              .to(t_dt))
    assert np.isnan(float(s_ref)) and np.isnan(float(ld_ref))
    assert torch.isnan(s) and torch.isnan(ld), (float(s), float(ld))


@pytest.mark.parametrize("update,fused,precision,dtype",
                         [(u, f, None, d) for u in ("rank1", "panel")
                          for f in (False, True) for d in DTYPES]
                         + [("panel", False, "bf16", "float32")])
def test_plan_nan_entry_gives_a_nan_sign(update, fused, precision, dtype):
    """Through the public entry points, as a caller runs them."""
    np_dt, t_dt = DTYPES[dtype]
    kw = dict(method="exact", update=update, fused=fused, precision=precision)
    j = repro.plan(jnp.asarray(NAN_A, np_dt), **kw)()
    t = repro_torch.plan(torch.from_numpy(NAN_A).to(t_dt), device="cpu",
                         **kw)()
    assert np.isnan(float(j.sign)) and np.isnan(float(j.logabsdet))
    assert torch.isnan(t.sign) and torch.isnan(t.logabsdet), (
        float(t.sign), float(t.logabsdet))


def test_nan_sign_helper():
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0, float("inf"), -float("inf"),
                      float("nan")])
    got = engine.nan_sign(x)
    assert got[:6].tolist() == [-1.0, 0.0, 0.0, 1.0, 1.0, -1.0]
    assert torch.isnan(got[6])
