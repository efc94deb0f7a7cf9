"""repro_torch on (B, n, n) stacks, on the CPU, against the JAX package on
the same numpy inputs.

* Exact stacks against the JAX package's vmapped plan (``repro.plan(stack,
  method="exact", ..., backend="interpret")``, the Pallas kernels in
  interpret mode, as tests/test_torch_engine.py runs the JAX engine; the
  ``xla`` backend for bf16 operands, see that file), serial and staged x
  rank1 and panel, fused, bf16 operands and ``ge``, on stacks built from
  the reference's adversarial cases (tests/test_engine.py:25-42) and on
  random stacks of B in {1, 3, 5}, n in {0, 1, 2, 17, 33, 70}.  Sign
  exact; log|det| within the single-matrix tests' tolerances (f64 1e-10,
  near_singular 1e-5; f32 1e-4; bf16 operands 5e-3) -- the frameworks
  differ in FMA contraction, the triangular solve and the GEMM's order.
* Matrix b of a stack equals the port's single-matrix plan on it: bit for
  bit on rank1, fused and ``ge`` (the same elementwise arithmetic, one
  launch for the stack); on panel within 1e-12 relative in f64 (1e-6 in
  f32), since a batched triangular solve or product may round otherwise.
  On this CPU build the panel routes are bitwise too, which
  `test_stack_matrix_equals_single_plan` records.
* A NaN matrix and a zero matrix leave the other matrices' results alone.
* The batched plain versions `ref.*` equal a loop of the single-matrix
  ones bit for bit.
* `BatchedOperator`: the protocol surface and products of the JAX one;
  Chebyshev (given bounds), SLQ, `estimate_logdet` and `logdet_batched`
  with the same probes in both packages (f64, rtol 1e-10); `cg_solve` with
  (B, n) and (B, n, k) right-hand sides, the same iteration count.
* Gradients: exact ``value_and_grad`` and autograd of ``logdet(x).sum()``
  against ``jax.grad`` of the JAX plan's summed logdet (f64 1e-10, relative
  to the largest entry); the estimator pullback on a `BatchedOperator`
  against the JAX pullback with the same probes (1e-8, both at CG
  tolerance 1e-10); one backward node per exact route on a stack.
* Plan rules: ``pge``/``plu`` and a mesh on a stack raise in both
  packages; ``method="auto"`` on a stack picks a serial route and runs it;
  the cost model counts the host's dispatch once per step of a stack.
* `examples/gmm_fit_torch.py` trains on the CPU (dim 8, 3 components, 5
  steps) with each method.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro
from repro import estimators as jest

import repro_torch
from repro_torch import estimators as est
from repro_torch.core import calibration as tcal
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.mesh import Mesh
from repro_torch.core.plan import ProblemSpec, clear_plan_cache, select_route
from repro_torch.kernels import ops, ref

from test_torch_engine import CASES, DTYPES, _cases_for, _rtol

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "examples"))

PANEL_K, MIN_SIZE = 8, 16
# route -> keywords both packages' plans take
ROUTES = {
    "serial|rank1": dict(method="exact", schedule="serial", update="rank1"),
    "staged|rank1": dict(method="exact", schedule="staged", update="rank1",
                         min_size=MIN_SIZE),
    "serial|panel": dict(method="exact", schedule="serial", update="panel",
                         k=PANEL_K),
    "staged|panel": dict(method="exact", schedule="staged", update="panel",
                         k=PANEL_K, min_size=MIN_SIZE),
    "ge": dict(method="ge"),
}
# the port's fused routes, held against the JAX package's unfused ones
# (equal bit for bit in both packages)
FUSED = {"staged|rank1|fused": "staged|rank1",
         "staged|panel|fused": "staged|panel"}
PORT_ROUTES = {**ROUTES, **{r: dict(ROUTES[u], fused=True)
                            for r, u in FUSED.items()}}
SIZES = [(1, 0), (3, 0), (3, 1), (5, 2), (3, 17), (5, 33), (1, 70), (3, 70)]
EST_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small matrices: intra-op threads gain nothing here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_plans():
    clear_plan_cache()
    yield
    clear_plan_cache()


def _stack(case: str) -> np.ndarray:
    """B = 3 from one adversarial case: the case, its rows permuted, and
    -2 times it with its columns permuted."""
    a = CASES[case]
    perm = np.random.default_rng(len(case)).permutation(a.shape[0])
    return np.stack([a, a[perm], -2.0 * a[:, perm]])


def _random_stack(b: int, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + 100 * n + b)
    return rng.standard_normal((b, n, n)) + 0.5 * n ** 0.5 * np.eye(n)


def make_spd(n, seed, shift=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2 * n))
    return x @ x.T / (2 * n) + shift * np.eye(n)


def _spd_stack(b, n, seed=0):
    return np.stack([make_spd(n, seed + s, shift=1.5 + 0.2 * s)
                     for s in range(b)])


def rademacher(shape, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0)


def _port(st: np.ndarray, route: str, dtype: str, precision=None):
    x = torch.from_numpy(st).to(DTYPES[dtype][1])
    res = repro_torch.plan(x, device="cpu", precision=precision,
                           **PORT_ROUTES[route])()
    return res.sign, res.logabsdet


@functools.lru_cache(maxsize=None)
def _jax_stack(key, route: str, dtype: str, precision=None):
    """(sign, logabsdet) of the JAX package's vmapped plan on the stack
    ``key`` names (a case, or ``("random", b, n)``)."""
    st = _stack(key) if isinstance(key, str) else _random_stack(*key[1:])
    kw = dict(ROUTES[route])
    if kw["method"] == "exact":
        kw["backend"] = "xla" if precision else "interpret"
    res = repro.plan(jnp.asarray(st, DTYPES[dtype][0]), precision=precision,
                     **kw)()
    return np.asarray(res.sign), np.asarray(res.logabsdet)


def _check_against_jax(got, want, rtol):
    s, ld = (v.numpy() for v in got)
    ws, wld = want
    assert s.shape == ws.shape and ld.shape == wld.shape
    np.testing.assert_array_equal(s, ws)
    np.testing.assert_allclose(ld, wld, rtol=rtol, atol=0)


# ------------------------------------------------------------ exact stacks

@pytest.mark.parametrize("dtype,case", [(d, c) for d in DTYPES
                                        for c in _cases_for(d)])
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_exact_stack_matches_jax(route, dtype, case):
    got = _port(_stack(case), route, dtype)
    want = _jax_stack(case, FUSED.get(route, route), dtype)
    _check_against_jax(got, want, _rtol(case, dtype))


@pytest.mark.parametrize("dtype,case", [(d, c) for d in DTYPES
                                        for c in _cases_for("float32")])
def test_bf16_stack_matches_jax(dtype, case):
    """bf16 operands (staged x panel) within the 5e-3 error model of the
    JAX package's xla backend and of numpy's f64 slogdet."""
    st = _stack(case)
    got = _port(st, "staged|panel", dtype, precision="bf16")
    want = _jax_stack(case, "staged|panel", dtype, precision="bf16")
    _check_against_jax(got, want, 5e-3)
    np.testing.assert_allclose(got[1].numpy(),
                               np.linalg.slogdet(st)[1], rtol=5e-3)


@pytest.mark.parametrize("b,n", SIZES)
@pytest.mark.parametrize("route", ["serial|rank1", "staged|panel", "ge"])
def test_stack_sizes_match_jax(route, b, n):
    got = _port(_random_stack(b, n), route, "float64")
    want = _jax_stack(("random", b, n), route, "float64")
    _check_against_jax(got, want, 1e-10)
    assert got[1].shape == (b,)
    if n:
        np.testing.assert_allclose(
            got[1].numpy(), np.linalg.slogdet(_random_stack(b, n))[1],
            rtol=1e-10)


_BITWISE_ON_CPU = {}


@pytest.mark.parametrize("b,n", SIZES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_stack_matrix_equals_single_plan(route, dtype, b, n):
    """Matrix b of a stack against the single-matrix plan of the same
    route on it: bitwise on rank1, fused and ge; panel within 1e-12 (f64)
    or 1e-6 (f32) relative, and recorded whether bitwise."""
    st = _random_stack(b, n, seed=7)
    s, ld = _port(st, route, dtype)
    for i in range(b):
        s1, ld1 = _port(st[i], route, dtype)
        assert torch.equal(s[i], s1)
        if "panel" in route:
            tol = 1e-12 if dtype == "float64" else 1e-6
            assert abs(float(ld[i]) - float(ld1)) <= tol * abs(float(ld1))
            _BITWISE_ON_CPU[route, dtype, b, n, i] = torch.equal(ld[i], ld1)
        else:
            assert torch.equal(ld[i], ld1), (i, float(ld[i]), float(ld1))
    if "panel" in route:
        # on this CPU build the batched solve and product round as the
        # single ones do
        assert all(v for k, v in _BITWISE_ON_CPU.items()
                   if k[:4] == (route, dtype, b, n))


@pytest.mark.parametrize("route", sorted(PORT_ROUTES))
def test_nan_and_zero_matrices_leave_the_others_alone(route):
    st = _random_stack(4, 17, seed=3)
    clean = _port(st, route, "float64")
    bad = st.copy()
    bad[1, 3, 5] = np.nan
    bad[2] = 0.0
    s, ld = _port(bad, route, "float64")
    for i in (0, 3):
        assert torch.equal(s[i], clean[0][i]) and torch.equal(ld[i],
                                                              clean[1][i])
    assert torch.isnan(s[1]) and torch.isnan(ld[1])
    assert float(s[2]) == 0.0 and float(ld[2]) == -np.inf


def test_stack_launch_path_matches_a_single_matrix():
    """The engine makes the same kernel calls for a stack as for one of
    its matrices: one per step, each on the whole stack."""
    calls = {}
    names = ("rank1_update", "panel_update", "panel_factor",
             "fused_condense_step")
    saved = {name: getattr(ops, name) for name in names}

    def counting(name):
        def f(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args, **kw)
        return f

    try:
        for name in names:
            setattr(ops, name, counting(name))
        counts = {}
        for shape in ((64, 64), (5, 64, 64)):
            calls.clear()
            for route in ("staged|rank1", "staged|panel|fused", "ge"):
                repro_torch.plan(torch.zeros(shape).normal_(), device="cpu",
                                 **PORT_ROUTES[route]).slogdet()
            counts[len(shape)] = dict(calls)
    finally:
        for name in names:
            setattr(ops, name, saved[name])
    assert counts[2] == counts[3] and counts[2]


# ------------------------------------------------- batched plain versions

def _rand(rng, *shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


@pytest.mark.parametrize("dt,op", [(torch.float32, torch.float32),
                                   (torch.float64, torch.float64),
                                   (torch.float32, torch.bfloat16),
                                   (torch.float64, torch.bfloat16)])
def test_batched_plain_versions_equal_a_loop(dt, op):
    rng = np.random.default_rng(5)
    b, m, n, k = 4, 9, 13, 3
    a = _rand(rng, b, m, n, dtype=dt)
    pc, pr = _rand(rng, b, m, dtype=op), _rand(rng, b, n, dtype=op)
    c, r = _rand(rng, b, m, k, dtype=op), _rand(rng, b, k, n, dtype=op)
    l = torch.tensor([0, 5, 12, 7])
    last = n - 1
    col_l = a.gather(2, l[:, None, None].expand(b, m, 1))[..., 0]
    col_last = a[:, :, last].contiguous()
    r1 = ref.rank1_update_ref(a, pc, pr)
    r2 = ref.panel_update_ref(a, c, r)
    r3 = ref.fused_step_ref(a, l, last, pc, pr, col_l, col_last)
    for i in range(b):
        assert torch.equal(r1[i], ref.rank1_update_ref(a[i], pc[i], pr[i]))
        assert torch.equal(r2[i], ref.panel_update_ref(a[i], c[i], r[i]))
        assert torch.equal(r3[i], ref.fused_step_ref(
            a[i], l[i:i + 1], last, pc[i], pr[i], col_l[i], col_last[i]))


@pytest.mark.parametrize("kind", ["random", "zero_row", "nan", "dead"])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_batched_panel_factor_and_pivots_equal_a_loop(kind, dt):
    rng = np.random.default_rng(6)
    b, k, n = 3, 5, 21
    p = _rand(rng, b, k, n, dtype=dt)
    m0, r_pos = (n - 4, 1) if kind == "dead" else (n, 0)
    if kind == "zero_row":
        p[1, 2] = 0.0
    elif kind == "nan":
        p[2, 1, 4] = float("nan")
    R, ls, s, ld = ref.panel_factor_ref(p, m0, r_pos)
    assert R.shape == p.shape and ls.shape == (b, k) and s.shape == (b,)
    for i in range(b):
        R1, ls1, s1, ld1 = ref.panel_factor_ref(p[i], m0, r_pos)
        assert torch.equal(R[i].nan_to_num(7.0), R1.nan_to_num(7.0))
        assert torch.equal(ls[i], ls1)
        assert torch.equal(s[i].nan_to_num(7.0), s1.nan_to_num(7.0))
        assert torch.equal(ld[i].nan_to_num(7.0), ld1.nan_to_num(7.0))
    st = _rand(rng, b, n, n, dtype=dt)
    for t in (0, 4, n - 2):
        got = ops.pivot_operands(st, t)
        for i in range(b):
            one = ops.pivot_operands(st[i], t)
            assert int(got[0][i]) == int(one[0][0])
            for g, w in zip(got[1:], one[1:]):
                assert torch.equal(g[i], w)


def test_pad_to_multiple_pads_each_matrix():
    st = torch.from_numpy(_random_stack(3, 5))
    out = pad_to_multiple(st, 4)
    assert out.shape == (3, 8, 8)
    for i in range(3):
        assert torch.equal(out[i], pad_to_multiple(st[i], 4))
    assert pad_to_multiple(st, 5) is st


# ------------------------------------------------------------ BatchedOperator

def test_batched_operator_surface_matches_jax():
    stack = _spd_stack(3, 10)
    jop = jest.BatchedOperator(jnp.asarray(stack))
    op = est.BatchedOperator(torch.from_numpy(stack))
    assert est.is_operator(op) and op.batch == jop.batch == 3
    assert op.shape == tuple(jop.shape) == (10, 10) and op.n == 10
    v = np.random.default_rng(0).standard_normal((3, 10, 4))
    vt = torch.from_numpy(v)
    for name in ("mm", "rmm"):
        np.testing.assert_allclose(getattr(op, name)(vt).numpy(),
                                   np.asarray(getattr(jop, name)(v)),
                                   rtol=1e-13)
    for name in ("mv", "rmv"):
        np.testing.assert_allclose(getattr(op, name)(vt[..., 0]).numpy(),
                                   np.asarray(getattr(jop, name)(v[..., 0])),
                                   rtol=1e-13)
    np.testing.assert_array_equal(op.diag().numpy(), np.asarray(jop.diag()))
    np.testing.assert_allclose(op.trace_hint().numpy(),
                               np.asarray(jop.trace_hint()), rtol=1e-14)
    assert op.to_dense() is op.stack
    assert op.plan_hints() == tuple(jop.plan_hints())
    moved = op.to("cpu")
    assert moved is not op and torch.equal(moved.stack, op.stack)
    assert est.as_operator(op) is op
    spec = repro_torch.plan(op, method="slq", device="cpu").spec
    assert spec.kind == "operator" and spec.batch == 3


def test_dense_batched_protocol_surface():
    """tests/test_operators.py::test_dense_batched_protocol_surface."""
    stack = np.stack([make_spd(10, s) for s in range(3)])
    bop = est.BatchedOperator(torch.from_numpy(stack))
    np.testing.assert_allclose(bop.diag().numpy(),
                               np.stack([np.diag(m) for m in stack]))
    np.testing.assert_allclose(bop.trace_hint().numpy(),
                               np.stack([np.trace(m) for m in stack]))


def _bounds(stack):
    ev = np.linalg.eigvalsh(stack)
    return ev[:, 0] * 0.9, ev[:, -1] * 1.1


@pytest.mark.parametrize("per_matrix", [True, False])
def test_chebyshev_on_a_stack_matches_jax(per_matrix):
    stack = _spd_stack(3, 17)
    z = rademacher((3, 17, 64), 1)
    lo, hi = _bounds(stack)
    if not per_matrix:
        lo, hi = float(lo.min()), float(hi.max())
    want = jest.logdet_chebyshev(jnp.asarray(stack), degree=32, probes=z,
                                 lmin=lo, lmax=hi)
    got = est.logdet_chebyshev(torch.from_numpy(stack), degree=32,
                               probes=torch.from_numpy(z),
                               lmin=torch.as_tensor(lo),
                               lmax=torch.as_tensor(hi), device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=EST_RTOL)
    err = np.abs(got.est.numpy() - np.linalg.slogdet(stack)[1])
    assert (err <= 5 * got.sem.numpy() + 1e-3).all()


def test_chebyshev_on_a_stack_draws_per_matrix_bounds():
    stack = _spd_stack(3, 17)
    op = est.BatchedOperator(torch.from_numpy(stack))
    lo, hi = est.spectral_bounds(op, torch.Generator().manual_seed(0))
    ev = np.linalg.eigvalsh(stack)
    assert lo.shape == hi.shape == (3,)
    assert (hi.numpy() >= ev[:, -1]).all() and (lo.numpy() > 0).all()
    res = est.logdet_chebyshev(op, degree=48, num_probes=64, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    err = np.abs(res.est.numpy() - np.linalg.slogdet(stack)[1])
    assert res.est.shape == (3,) and (err <= 5 * res.sem.numpy() + 1e-3).all()


def test_slq_on_a_stack_matches_jax():
    stack = _spd_stack(3, 17)
    z = rademacher((3, 17, 12), 2)
    want = jest.logdet_slq(jnp.asarray(stack), num_steps=10, probes=z)
    got = est.logdet_slq(torch.from_numpy(stack), num_steps=10,
                         probes=torch.from_numpy(z), device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=EST_RTOL)
    a, b = jest.lanczos(jest.BatchedOperator(jnp.asarray(stack)).mm,
                        jnp.asarray(z), 6)
    ta, tb = est.lanczos(est.BatchedOperator(torch.from_numpy(stack)).mm,
                         torch.from_numpy(z), 6)
    assert ta.shape == (3, 12, 6) and tb.shape == (3, 12, 5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), rtol=1e-10)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=1e-10)


@pytest.mark.parametrize("method,kw", [("chebyshev", dict(degree=24)),
                                       ("slq", dict(num_steps=12))])
def test_estimate_logdet_and_logdet_batched_match_jax(method, kw):
    stack = _spd_stack(4, 24, seed=2)
    z = rademacher((4, 24, 16), 3)
    if method == "chebyshev":
        lo, hi = _bounds(stack)
        kw = dict(kw, lmin=lo, lmax=hi)
    want = jest.estimate_logdet(jnp.asarray(stack), method=method, probes=z,
                                **kw)
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = est.estimate_logdet(torch.from_numpy(stack), method=method,
                              probes=torch.from_numpy(z), device="cpu",
                              **tkw)
    np.testing.assert_allclose(got.est.numpy(), np.asarray(want.est),
                               rtol=EST_RTOL)
    np.testing.assert_allclose(got.sem.numpy(), np.asarray(want.sem),
                               rtol=EST_RTOL)
    jb = jest.logdet_batched(jnp.asarray(stack), method=method, probes=z,
                             **kw)
    tb = est.logdet_batched(torch.from_numpy(stack), method=method,
                            probes=torch.from_numpy(z), device="cpu", **tkw)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=EST_RTOL)
    ob = est.logdet_batched(est.BatchedOperator(torch.from_numpy(stack)),
                            method=method, probes=torch.from_numpy(z),
                            device="cpu", **tkw)
    assert torch.equal(ob, tb)
    plan_ld = repro_torch.plan(torch.from_numpy(stack), method=method,
                               device="cpu", **{k: v for k, v in kw.items()
                                                if k not in ("lmin", "lmax")}
                               )(probes=torch.from_numpy(z),
                                 lmin=tkw.get("lmin"), lmax=tkw.get("lmax"))
    assert torch.equal(plan_ld.logabsdet, tb)
    assert plan_ld.sign.shape == plan_ld.sem.shape == (4,)


def test_logdet_batched_exact_routes_and_rejections():
    """tests/test_operators.py::test_logdet_batched_accepts_batched_operator,
    and the exact routes through a plan."""
    stack = np.stack([make_spd(48, s, shift=1.5 + 0.1 * s) for s in range(4)])
    want = np.array([np.linalg.slogdet(m)[1] for m in stack])
    op = est.BatchedOperator(torch.from_numpy(stack))
    got = est.logdet_batched(op, method="slq", num_steps=25, num_probes=48,
                             seed=0, device="cpu").numpy()
    assert got.shape == (4,)
    assert np.median(np.abs(got - want) / np.abs(want)) < 1e-2
    for method, kw in (("exact", {}), ("exact", dict(update="panel", k=8)),
                       ("ge", {})):
        ld = est.logdet_batched(stack, method=method, device="cpu", **kw)
        np.testing.assert_allclose(ld.numpy(), want, rtol=1e-10)
    with pytest.raises(TypeError, match="materialized"):
        est.logdet_batched(op, method="exact")
    with pytest.raises(ValueError, match="batched operator"):
        est.logdet_batched(est.DenseOperator(torch.from_numpy(stack[0])),
                           method="slq")
    with pytest.raises(TypeError, match="ONE matrix"):
        est.logdet_batched(stack, method="pge", device="cpu")


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("precondition", [True, False])
def test_cg_on_a_stack_matches_jax(vec, precondition):
    stack = np.stack([make_spd(24, s, shift=1.5 + 0.2 * s) for s in range(4)])
    b = np.random.default_rng(4).standard_normal((4, 24) if vec
                                                 else (4, 24, 3))
    b[2, ...] = 0.0                      # a zero right-hand side
    want = jest.cg_solve(jest.BatchedOperator(jnp.asarray(stack)),
                         jnp.asarray(b), precondition=precondition)
    got = est.cg_solve(est.BatchedOperator(torch.from_numpy(stack)),
                       torch.from_numpy(b), precondition=precondition,
                       device="cpu")
    assert got.iters == int(want.iters) and bool(got.converged)
    assert got.x.shape == b.shape
    assert got.resnorm.shape == want.resnorm.shape == (4, 1 if vec else 3)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-12)
    solve = np.stack([np.linalg.solve(stack[i], b[i]) for i in range(4)])
    np.testing.assert_allclose(got.x.numpy(), solve, rtol=1e-7, atol=1e-8)
    tr = est.cg_solve(torch.from_numpy(stack), torch.from_numpy(b),
                      transpose=True, device="cpu")
    np.testing.assert_allclose(tr.x.numpy(), solve, rtol=1e-7, atol=1e-8)


def test_cg_batched_operator():
    """tests/test_operators.py::test_cg_batched_operator."""
    stack = np.stack([make_spd(24, s, shift=1.5 + 0.2 * s) for s in range(4)])
    b = np.random.default_rng(0).standard_normal((4, 24, 3))
    res = est.cg_solve(est.BatchedOperator(torch.from_numpy(stack)),
                       torch.from_numpy(b), device="cpu")
    want = np.stack([np.linalg.solve(stack[i], b[i]) for i in range(4)])
    assert bool(res.converged)
    assert res.resnorm.shape == (4, 3)
    np.testing.assert_allclose(res.x.numpy(), want, rtol=1e-7, atol=1e-8)


def test_cg_rejects_a_right_hand_side_of_the_wrong_rank():
    stack = torch.from_numpy(_spd_stack(2, 5))
    with pytest.raises(ValueError, match="batch axis"):
        est.cg_solve(stack, torch.ones(5), device="cpu")
    with pytest.raises(ValueError, match="batch axis"):
        est.cg_solve(stack[0], torch.ones(2, 5, 1), device="cpu")


# ----------------------------------------------------------------- gradients

def _assert_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * scale


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exact_stack_grad_matches_jax(route):
    """vmap(grad) in the JAX package (tests/test_grad.py:359): the gradient
    of the summed logdet of a stack, each matrix's A^{-T}, through
    value_and_grad and through autograd, with one backward node."""
    stack = np.stack([make_spd(12, s) for s in range(3)])
    stack[1] = np.random.default_rng(1).standard_normal((12, 12)) \
        + 3.0 * np.eye(12)                       # non-symmetric
    kw = ROUTES[route]
    jp = repro.plan(jnp.asarray(stack), **kw)
    gj = np.asarray(jax.grad(lambda s: jp.logdet(s).sum())(
        jnp.asarray(stack)))
    p = repro_torch.plan(torch.from_numpy(stack), device="cpu", **kw)
    res, g = p.value_and_grad()
    x = torch.from_numpy(stack).requires_grad_()
    ld = p.logdet(x)
    node = ld.grad_fn
    assert node.name() == "_ExactSlogdetBackward"
    assert [f.name() for f, _ in node.next_functions if f is not None] == \
        ["torch::autograd::AccumulateGrad"]
    ld.sum().backward()
    inv_t = np.stack([np.linalg.inv(m).T for m in stack])
    for grad in (g, x.grad):
        _assert_close(grad, gj, 1e-10)
        _assert_close(grad, inv_t, 1e-10)
    assert torch.equal(res.logabsdet, ld.detach())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_exact_stack_grad_at_n0(route):
    res, g = repro_torch.plan(np.zeros((3, 0, 0)), device="cpu",
                              **ROUTES[route]).value_and_grad()
    assert g.shape == (3, 0, 0) and res.logabsdet.shape == (3,)
    x = torch.zeros((3, 0, 0), dtype=torch.float64, requires_grad=True)
    repro_torch.plan(x.detach(), device="cpu",
                     **ROUTES[route]).logdet(x).sum().backward()
    assert x.grad.shape == (3, 0, 0)


@pytest.mark.parametrize("method,kw", [("chebyshev", dict(degree=24)),
                                       ("slq", dict(num_steps=12))])
def test_estimator_stack_grad_matches_jax(method, kw):
    """The batched Hutchinson pullback on the forward's probes, per matrix
    (g (B,)): the port's pullback against the JAX one, and autograd of the
    plan's summed logdet against jax.grad, with the same probes."""
    stack = _spd_stack(3, 16, seed=4)
    z = rademacher((3, 16, 24), 5)
    g = np.array([1.0, -0.5, 2.0])
    jop = jest.BatchedOperator(jnp.asarray(stack))
    jbar, jcg = jest.hutchinson_pullback(jop, jop.stack, jnp.asarray(z),
                                         jnp.asarray(g), cg_tol=1e-10)
    op = est.BatchedOperator(torch.from_numpy(stack))
    bar, cg = est.hutchinson_pullback(op, op.stack, torch.from_numpy(z),
                                      torch.from_numpy(g), cg_tol=1e-10)
    assert cg.iters == int(jcg.iters)
    _assert_close(bar, jbar, 1e-8)
    for i in range(3):
        w = np.linalg.solve(stack[i].T, z[i])
        _assert_close(bar[i], g[i] * w @ z[i].T / z.shape[-1], 1e-8)
    if method == "chebyshev":
        lo, hi = _bounds(stack)
        kw = dict(kw, lmin=float(lo.min()), lmax=float(hi.max()))
    pkw = dict(kw, grad_cg_tol=1e-10)
    bounds = {k: pkw.pop(k) for k in ("lmin", "lmax") if k in pkw}
    jp = repro.plan(jnp.asarray(stack), method=method, **pkw)
    gj = np.asarray(jax.grad(lambda s: jp.logdet(
        s, probes=jnp.asarray(z), **bounds).sum())(jnp.asarray(stack)))
    p = repro_torch.plan(torch.from_numpy(stack), method=method,
                         device="cpu", **pkw)
    x = torch.from_numpy(stack).requires_grad_()
    p.logdet(x, probes=torch.from_numpy(z), **bounds).sum().backward()
    _assert_close(x.grad, gj, 1e-8)
    res, vg = p.value_and_grad(generator=torch.Generator().manual_seed(0))
    assert vg.shape == stack.shape and res.logabsdet.shape == (3,)
    assert res.diagnostics.cg_iters > 0


# ---------------------------------------------------------------- plan rules

@pytest.mark.parametrize("method", ["pge", "plu"])
def test_parallel_baselines_reject_stacks(method):
    """pge and plu distribute ONE matrix, with or without a mesh, in both
    packages."""
    with pytest.raises(TypeError) as jax_err:
        repro.plan((2, 8, 8), method=method)
    with pytest.raises(jax_err.type, match="ONE matrix"):
        repro_torch.plan((2, 8, 8), method=method, device="cpu")
    one = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(TypeError, match="single"):
        repro_torch.plan((2, 8, 8), method=method, device="cpu", mesh=one)


def test_plan_checks_the_stack_shape():
    p = repro_torch.plan((3, 8, 8), method="exact", device="cpu")
    with pytest.raises(ValueError, match=r"\(3, 8, 8\)"):
        p(torch.eye(8))
    with pytest.raises(ValueError, match=r"\(3, 8, 8\)"):
        p(torch.zeros(2, 8, 8))
    assert p.diagnostics.flops_est == 3 * (2.0 / 3.0) * 8 ** 3


@pytest.mark.parametrize("n", [17, 200])
def test_auto_picks_a_serial_route_for_a_stack(n):
    st = torch.from_numpy(_spd_stack(3, n))
    route = select_route(ProblemSpec("batched", n, 3, "float64",
                                     matvec_flops=2.0 * n * n))
    assert route[0] == "exact" and route[1].schedule == "serial"
    p = repro_torch.plan(st, device="cpu")
    assert p.method == "exact" and p.config.schedule == "serial"
    np.testing.assert_allclose(p().logabsdet.numpy(),
                               np.linalg.slogdet(st.numpy())[1], rtol=1e-10)


def test_stack_host_term_is_counted_once_per_step():
    """A synthetic table: the host's dispatch is n * term for a stack of
    any size (its steps run all matrices at once), while the compute
    term grows with the stack."""
    base = tcal.Calibration(gemm_flops=1e12, stream_bytes=1e12,
                            collective_lat=1e-5, collective_bytes=1e10)
    host = tcal.Calibration(gemm_flops=1e12, stream_bytes=1e12,
                            collective_lat=1e-5, collective_bytes=1e10,
                            host_rank1_row_s=3e-4, host_panel_row_s=6e-5)
    for update, term in (("rank1", 3e-4), ("panel", 6e-5)):
        for n in (60, 1024):
            kw = dict(update=update, panel_k=8, itemsize=4)
            one = tcal.exact_cost(n, 1, base, batch=1, **kw)
            for batch in (1, 16, 2048):
                cost = tcal.exact_cost(n, 1, host, batch=batch, **kw)
                np.testing.assert_allclose(
                    cost - tcal.exact_cost(n, 1, base, batch=batch, **kw),
                    n * term, rtol=1e-9)
                np.testing.assert_allclose(
                    tcal.exact_cost(n, 1, base, batch=batch, **kw),
                    batch * one, rtol=1e-12)


# ---------------------------------------------------------- the GMM twin

@pytest.mark.parametrize("method", ["exact", "chebyshev", "slq"])
def test_gmm_fit_torch_trains(method):
    import gmm_fit_torch
    hist = gmm_fit_torch.train(dim=8, components=3, samples=300, steps=5,
                               method=method, device="cpu", log_every=0)
    nll = hist["nll"]
    assert np.isfinite(nll).all() and nll[-1] < nll[0]
    assert np.isfinite(hist["ld_gap"]).all() and len(hist["step_s"]) == 5
    if method == "exact":
        assert hist["ld_gap"].max() < 1e-10
