"""The port's Gaussian-elimination baselines (``ge``, ``pge``, ``plu``) and
the serial condensation wrappers on the CPU, against the JAX package.

Inputs: the cases of tests/test_engine.py:25-42 (random, scaled_odd,
permutation, negative_det, near_singular) and a Gaussian matrix with a
NaN entry.  The parallel baselines run on P = 1, 2 and 4 ranks under
gloo (one spawn per P, `repro_torch.core.mesh.run_ranks`; the rank
function is tests/test_torch_ranks.py:baseline_routes), every case padded
with diag(A, I) to PAD rows, a multiple of lcm(P, nb) for every P and nb
here; the JAX references at P = 1 in this process, at P = 2 and 4 in a
subprocess with that many fake devices (tests/_subproc.py).

Tolerances, as in tests/test_torch_mesh.py: sign exact; log|det| rtol
1e-10 in f64, 1e-4 in f32, 1e-5 for ``near_singular`` (f64 only).

The JAX package's pge and plu multiply their sign by the parity of the
cyclic row permutation, although their rows keep their global indices:
wherever that parity is -1 (N = 38 on two devices) their sign is
wrong.  The port's is numpy's (`test_reference_parity_fault`); at PAD
the parity is +1 for every P, so the two packages agree there.
"""
import functools
import json
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro._compat import make_mesh
from repro.core import condense as jax_condense
from repro.core import engine as jax_engine
from repro.core import pad_to_multiple as jax_pad
from repro.core.gaussian import parallel_slogdet_ge as jax_pge
from repro.core.gaussian import slogdet_ge as jax_ge
from repro.core.scalapack import parallel_slogdet_lu as jax_plu

import test_torch_ranks as ranks
from _subproc import SRC, run_with_devices
from test_torch_mesh import NAN_CASE, _cases

import repro_torch
from repro_torch.core import condense, engine
from repro_torch.core.gaussian import slogdet_ge
from repro_torch.core.mesh import Mesh, run_ranks

SIZES = (1, 2, 4)
NBS = (1, 3, 8)
PAD = 48
SPAWN_TIMEOUT = 300
CASES = _cases()
ALL_CASES = {**CASES, "nan": NAN_CASE}
DTYPES = ("float32", "float64")
ROUTES = [(c, d) for d in DTYPES for c in sorted(CASES)
          if not (d == "float32" and c == "near_singular")]
METHODS = ("pge", *(f"plu{nb}" for nb in NBS))
# the reference's parity fault: N = 37 padded to 38 on two ranks
FAULT = np.random.default_rng(0).standard_normal((37, 37))


def _rtol(case, dtype):
    if dtype == "float32":
        return 1e-4
    return 1e-5 if case == "near_singular" else 1e-10


@functools.lru_cache(maxsize=None)
def _port(size: int):
    """Every rank's results for mesh size ``size`` (one spawn)."""
    extra = {"fault": (FAULT, 38)} if size == 2 else None
    return run_ranks(ranks.baseline_routes, size, backend="gloo",
                     device="cpu", timeout=SPAWN_TIMEOUT,
                     args=(ALL_CASES, PAD, NBS, extra))


_JAX_CODE = """
import json, sys
sys.path.insert(0, {src!r})
from repro._compat import make_mesh
from repro.core import pad_to_multiple
from repro.core.gaussian import parallel_slogdet_ge
from repro.core.scalapack import parallel_slogdet_lu
data = np.load({path!r})
mesh = make_mesh(({size},), ("rows",))
fns = {{"pge": parallel_slogdet_ge(mesh),
        **{{f"plu{{nb}}": parallel_slogdet_lu(mesh, nb=nb)
           for nb in {nbs!r}}}}}
out = {{}}
for key in data.files:
    a = jnp.asarray(data[key])
    if key == "fault":
        s, ld = fns["pge"](pad_to_multiple(a, 38))
        out["fault|pge"] = [float(s), float(ld)]
        continue
    for name, fn in fns.items():
        s, ld = fn(pad_to_multiple(a, {pad}))
        out[key + "|" + name] = [float(s), float(ld)]
print(json.dumps(out))
"""


def _jax_routes(fns, a):
    out = {}
    for name, fn in fns.items():
        s, ld = fn(jax_pad(jnp.asarray(a), PAD))
        out[name] = [float(s), float(ld)]
    return out


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """``{size: {"case|dtype|method": [sign, logabsdet]}}`` of the JAX
    package's pge and plu."""
    mesh1 = make_mesh((1,), ("rows",))
    fns = {"pge": jax_pge(mesh1),
           **{f"plu{nb}": jax_plu(mesh1, nb=nb) for nb in NBS}}
    refs = {1: {}}
    for case, a in ALL_CASES.items():
        for dtype in DTYPES:
            for name, v in _jax_routes(fns, a.astype(dtype)).items():
                refs[1][f"{case}|{dtype}|{name}"] = v
    for size in (2, 4):
        path = str(tmp_path_factory.mktemp("jax_ge") / f"p{size}.npz")
        arrays = {f"{c}|{d}": a.astype(d) for c, a in ALL_CASES.items()
                  for d in DTYPES}
        if size == 2:
            arrays["fault"] = FAULT
        np.savez(path, **arrays)
        code = _JAX_CODE.format(src=SRC, path=path, size=size, nbs=NBS,
                                pad=PAD)
        stdout = run_with_devices(code, size, timeout=SPAWN_TIMEOUT)
        refs[size] = json.loads(stdout.strip().splitlines()[-1])
    return refs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- serial ge

@pytest.mark.parametrize("case,dtype", ROUTES)
def test_serial_ge_matches_jax(case, dtype):
    a = CASES[case].astype(dtype)
    s, ld = (float(v) for v in slogdet_ge(torch.from_numpy(a)))
    s_ref, ld_ref = (float(v) for v in jax_ge(jnp.asarray(a)))
    assert s == s_ref
    np.testing.assert_allclose(ld, ld_ref, rtol=_rtol(case, dtype))
    s_np, ld_np = np.linalg.slogdet(CASES[case])
    assert s == s_np
    np.testing.assert_allclose(ld, ld_np, rtol=_rtol(case, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_serial_ge_nan_entry(dtype):
    """NaN counts as the maximum in the pivot search (torch.argmax as
    jnp.argmax), so the NaN becomes a pivot: sign and log|det| NaN in
    both packages."""
    a = NAN_CASE.astype(dtype)
    s, ld = (float(v) for v in slogdet_ge(torch.from_numpy(a)))
    s_ref, ld_ref = (float(v) for v in jax_ge(jnp.asarray(a)))
    assert math.isnan(s_ref) and math.isnan(ld_ref)
    assert math.isnan(s) and math.isnan(ld)


def test_argmax_takes_nan_and_the_first_maximum():
    """The pivot search relies on both packages' argmax: NaN is the
    maximum, and of equal maxima the first wins."""
    for v in ([1.0, np.nan, 3.0, np.nan], [2.0, 5.0, 5.0], [-np.inf, 0.0]):
        assert int(torch.tensor(v).argmax()) == int(jnp.argmax(
            jnp.asarray(v)))


def test_ge_plan_and_edges():
    a = CASES["negative_det"]
    p = repro_torch.plan(a, method="ge", device="cpu")
    res = p()
    assert p.method == "ge" and res.method_used == "ge"
    assert p.diagnostics.padded_n == a.shape[0]
    s, ld = (float(v) for v in slogdet_ge(torch.from_numpy(a)))
    assert (float(res.sign), float(res.logabsdet)) == (s, ld)
    for n in (0, 1):
        x = np.eye(n) * 3.0
        s, ld = (float(v) for v in slogdet_ge(torch.from_numpy(x)))
        s_ref, ld_ref = (float(v) for v in jax_ge(jnp.asarray(x)))
        assert (s, ld) == (s_ref, ld_ref)
    with pytest.raises(TypeError, match="generator"):
        p(generator=torch.Generator())
    for method in ("pge", "plu"):
        with pytest.raises(ValueError, match="requires a mesh"):
            repro_torch.plan(a, method=method, device="cpu")
    with pytest.raises(ValueError, match="nb"):
        repro_torch.plan(a, method="plu", nb=0, device="cpu")


# ------------------------------------------------------- pge and plu

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("case,dtype", ROUTES)
@pytest.mark.parametrize("size", SIZES)
def test_parallel_baselines_match_jax(jax_refs, size, case, dtype, method):
    s, ld, _, _ = _port(size)[0][f"{case}|{dtype}|{method}"]
    s_ref, ld_ref = jax_refs[size][f"{case}|{dtype}|{method}"]
    assert engine.perm_parity(engine.cyclic_perm(PAD, size)) == 1.0
    assert s == s_ref, (s, s_ref)
    np.testing.assert_allclose(ld, ld_ref, rtol=_rtol(case, dtype),
                               atol=1e-8)
    s_np, ld_np = np.linalg.slogdet(CASES[case])
    assert s == s_np
    np.testing.assert_allclose(ld, ld_np, rtol=_rtol(case, dtype),
                               atol=1e-8)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", SIZES)
def test_parallel_baselines_nan_entry(jax_refs, size, dtype, method):
    s, ld, _, _ = _port(size)[0][f"nan|{dtype}|{method}"]
    s_ref, ld_ref = jax_refs[size][f"nan|{dtype}|{method}"]
    assert math.isnan(s_ref) and math.isnan(ld_ref)
    assert math.isnan(s) and math.isnan(ld)


@pytest.mark.parametrize("size", SIZES)
def test_parallel_baselines_calls_and_collectives(size):
    """Per rank: K1 / K2 calls and collectives by the formulas of
    chip_smoke.py (`baseline_launches`, `baseline_collectives`): a rank
    updates while it holds rows below the pivot row, i.e. for the steps
    before its last global row g = (N / P - 1) P + rank; pge calls K1
    g times, plu K2 floor(g / nb) times and K1 g - floor(g / nb) times;
    every step costs two all_sums and one broadcast, plu's panels one
    all_sum more."""
    for rank, res in enumerate(_port(size)):
        last = (PAD // size - 1) * size + rank
        for case, dtype in ROUTES:
            for method in METHODS:
                _, _, calls, colls = res[f"{case}|{dtype}|{method}"]
                nb = 1 if method == "pge" else int(method[3:])
                panels = 0 if method == "pge" else last // nb
                assert calls == {"rank1_update": last - panels,
                                 "panel_update": panels}, (rank, method)
                assert colls == {"broadcast": PAD, "all_sum": 2 * PAD + (
                    0 if method == "pge" else PAD // nb)}, (rank, method)


@pytest.mark.parametrize("size", SIZES)
def test_every_rank_returns_the_same_result(size):
    """Sign and log|det| bit for bit (NaNs alike); the calls differ by
    rank, the collectives do not."""
    results = _port(size)
    for r, res in enumerate(results[1:], 1):
        assert res.keys() == results[0].keys()
        for key, value in res.items():
            first = results[0][key]
            if len(value) == 4:
                value, first = (value[:2], value[3]), (first[:2], first[3])
            assert str(value) == str(first), (r, key, value, first)


@pytest.mark.parametrize("size", SIZES)
def test_baseline_plans(size):
    """``plan(method="pge"|"plu", mesh=m)`` pads the 48-row first case to
    a multiple of P (of lcm(P, nb) for plu) and runs on every rank."""
    got = _port(size)[0]
    s_np, ld_np = np.linalg.slogdet(next(iter(CASES.values())))
    for method, mult in (("pge", size), ("plu", math.lcm(size, NBS[-1]))):
        (s, ld), padded_n, devices = got[f"plan|{method}"]
        assert padded_n == -(-48 // mult) * mult and devices == size
        assert s == s_np
        np.testing.assert_allclose(ld, ld_np, rtol=1e-10)


def test_reference_parity_fault(jax_refs):
    """N = 37 padded to 38 on two ranks: the cyclic permutation is odd,
    and the JAX package's pge returns the negated sign; the port's is
    numpy's.  log|det| agrees."""
    s_np, ld_np = np.linalg.slogdet(FAULT)
    assert engine.perm_parity(engine.cyclic_perm(38, 2)) == -1.0
    s, ld = _port(2)[0]["fault|pge"]
    s_ref, ld_ref = jax_refs[2]["fault|pge"]
    assert s == s_np == -s_ref
    np.testing.assert_allclose(ld, ld_np, rtol=1e-10)
    np.testing.assert_allclose(ld, ld_ref, rtol=1e-10)


# -------------------------------------------------- helpers and wrappers

@pytest.mark.parametrize("n,p", [(1, 1), (12, 1), (12, 3), (38, 2),
                                 (48, 4), (64, 8)])
def test_cyclic_perm_and_parity_match_jax(n, p):
    perm = engine.cyclic_perm(n, p)
    np.testing.assert_array_equal(perm, jax_engine.cyclic_perm(n, p))
    assert engine.perm_parity(perm) == jax_engine.perm_parity(perm)
    # the rows a rank holds are the cyclic block _cyclic_block takes
    from repro_torch.core.gaussian import _cyclic_block
    a = torch.arange(n, dtype=torch.float64)[:, None].expand(n, n)
    for rank in range(p):
        mesh = Mesh(group=None, size=p, rank=rank, device=torch.device("cpu"))
        got = _cyclic_block(a, mesh)[:, 0].long().numpy()
        np.testing.assert_array_equal(got, perm[mesh.block(n)])


@pytest.mark.parametrize("case,dtype", ROUTES)
def test_condense_wrappers_match_jax(case, dtype):
    a = CASES[case].astype(dtype)
    rtol = _rtol(case, dtype)
    at = torch.from_numpy(a)
    for port_fn, jax_fn in (
            (condense.slogdet_condense, jax_condense.slogdet_condense),
            (functools.partial(condense.slogdet_condense_staged,
                               min_size=16),
             functools.partial(jax_condense.slogdet_condense_staged,
                               min_size=16))):
        s, ld = (float(v) for v in port_fn(at))
        s_ref, ld_ref = (float(v) for v in jax_fn(jnp.asarray(a)))
        assert s == s_ref
        np.testing.assert_allclose(ld, ld_ref, rtol=rtol)
    # condense_steps on a copy + combine_slogdet of two halves
    half = a.shape[0] // 2
    buf, s1, l1 = condense.condense_steps(at.clone(), half)
    buf, s2, l2 = condense.condense_steps(buf, a.shape[0] - 1 - half,
                                          t0=half)
    s, ld = (float(v) for v in condense.combine_slogdet([(s1, l1),
                                                         (s2, l2)]))
    last = float(buf[-1, 0])
    s, ld = s * float(np.sign(last)), ld + float(np.log(abs(last)))
    s_np, ld_np = np.linalg.slogdet(CASES[case])
    assert s == s_np
    np.testing.assert_allclose(ld, ld_np, rtol=rtol)
