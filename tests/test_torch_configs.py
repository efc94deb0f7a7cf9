"""`repro_torch.configs` and the models' shared layers against the JAX
package: the ten archs' configs field for field, ``layer_windows``,
``count_params`` and ``model_flops`` of the full configs, every (arch x
shape) ``input_specs`` on the meta device, ``skip_shapes``, the
``init_model`` rule, the layers of ``models/common.py``, MoE capacity,
the ``estimators.matvec`` shim, and that the new subpackages stay free
of JAX and default to the card."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.estimators.matvec as jax_matvec
from repro.configs import registry as jreg
from repro.configs.shapes import SHAPES as JSHAPES
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models import moe as jmoe

import repro_torch.estimators.matvec as port_matvec
from repro_torch import estimators as est
from repro_torch.configs import registry as reg
from repro_torch.configs.shapes import SHAPES
from repro_torch.data import synth_batch, DataConfig
from repro_torch.models import common, init_model
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.convert import from_jax_params, unstacked

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(jreg.ARCHS)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _jax_dtype_name(dt) -> str:
    return jnp.dtype(dt).name


# ------------------------------------------------------------ registry

def test_archs_and_shapes_equal_jax():
    assert reg.ARCHS == jreg.ARCHS and reg.arch_ids() == jreg.arch_ids()
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        reg.get_config("no-such-arch")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_jax(arch, smoke):
    """Every field of the ModelConfig, dtypes by name (torch for jnp)."""
    got = reg.get_config(arch, smoke=smoke)
    want = jreg.get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert isinstance(a, torch.dtype), f.name
            assert _dtype_name(a) == _jax_dtype_name(b), (f.name, a, b)
        else:
            assert a == b, (f.name, a, b)
    for prop in ("hd", "d_inner", "nh_ssm"):
        assert _prop(got, prop) == _prop(want, prop), prop


def _prop(cfg, name):
    """A derived property, or the error it raises (mamba2 has no heads)."""
    try:
        return getattr(cfg, name)
    except ZeroDivisionError as e:
        return type(e)


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_shapes_equal_jax(arch):
    assert reg.skip_shapes(arch) == jreg.skip_shapes(arch)


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_on_meta_equal_jax(arch, shape):
    """The full config's batch specs: meta tensors (no storage) with the
    JAX ShapeDtypeStructs' shapes and dtypes, key for key."""
    cfg, shp, specs = reg.input_specs(arch, shape)
    jcfg, jshp, jspecs = jreg.input_specs(arch, shape)
    assert dataclasses.astuple(shp) == dataclasses.astuple(jshp)
    assert list(specs) == list(jspecs)
    for k, v in specs.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == jspecs[k].shape, (arch, shape, k)
        assert _dtype_name(v.dtype) == _jax_dtype_name(jspecs[k].dtype)
    smoke_cfg, _, _ = reg.input_specs(arch, shape, smoke=True)
    assert smoke_cfg == reg.get_config(arch, smoke=True)
    assert reg.input_specs(cfg, shape)[0] is cfg


def test_layer_windows_of_gemma3():
    cfg, jcfg = reg.get_config("gemma3-1b"), jreg.get_config("gemma3-1b")
    w = M.layer_windows(cfg)
    np.testing.assert_array_equal(w, JM.layer_windows(jcfg))
    assert w.dtype == np.int32 and w.shape == (26,)
    assert (w[5::6] == 0).all()
    assert (np.delete(w, np.s_[5::6]) == 512).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_flops_equal_jax(arch):
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    for active in (False, True):
        assert M.count_params(cfg, active_only=active) == \
            JM.count_params(jcfg, active_only=active)
    assert M.model_flops(cfg, 4096) == JM.model_flops(jcfg, 4096)
    np.testing.assert_array_equal(M.layer_windows(cfg),
                                  JM.layer_windows(jcfg))


# ------------------------------------------------------------ init rule

def _pooled(d, names):
    return np.concatenate([np.asarray(d[n], np.float64).ravel()
                           for n in names])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_follows_the_init_rule(arch):
    """Against the JAX ``init_model(PRNGKey(0), cfg)`` of the smoke config:
    the same parameter names (stacked axes unstacked), shapes and dtypes;
    zeros exactly where JAX has zeros; and each parameter's values, pooled
    over layers, with the JAX ones' standard deviation within 5 standard
    errors and a mean within 5 standard errors of 0 (the frameworks draw
    other numbers from one seed, so values are never compared)."""
    jcfg = jreg.get_config(arch, smoke=True)
    cfg = reg.get_config(arch, smoke=True)
    want = unstacked(jax.device_get(JM.init_model(jax.random.PRNGKey(0),
                                                  jcfg)))
    model = init_model(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    got = {n: p.detach() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, p in got.items():
        assert tuple(p.shape) == want[n].shape, n
        assert _dtype_name(p.dtype) == want[n].dtype.name, n
        assert p.device.type == "cpu"
    # pool every layer's copy of one parameter: "blocks.3.attn.wq" ->
    # "blocks.*.attn.wq"
    groups = {}
    for n in got:
        key = ".".join("*" if part.isdigit() else part
                       for part in n.split("."))
        groups.setdefault(key, []).append(n)
    for key, names in groups.items():
        w = _pooled(want, names)
        g = _pooled({n: got[n].float().numpy() for n in names}, names)
        if not w.any():
            assert not g.any(), key
            continue
        sw, sg = w.std(), g.std()
        se = np.sqrt(1 / (2 * w.size) + 1 / (2 * g.size))
        assert abs(sg / sw - 1) <= 5 * se + 0.01, (key, sg, sw)
        assert abs(g.mean()) <= 5 * sw / np.sqrt(g.size), (key, g.mean())


def test_init_model_same_seed_same_numbers_other_seed_others():
    cfg = reg.get_config("qwen2.5-3b", smoke=True)

    def params(seed):
        m = init_model(cfg, generator=torch.Generator().manual_seed(seed),
                       device="cpu")
        return [p.detach() for p in m.parameters()]

    a, b, c = params(0), params(0), params(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_param_rule():
    """``param``: 1/sqrt(shape[0]) for a matrix, 0.02 for a vector, the
    given scale, zeros -- through the init it is handed."""
    seen = []

    def init(shape, dtype, scale):
        seen.append((shape, dtype, scale))
        return torch.zeros(shape, dtype=dtype)

    common.param(init, (16, 4, 2), torch.float32)
    common.param(init, (8,), torch.bfloat16)
    common.param(init, (8, 3), torch.float32, scale=0.5)
    common.param(init, (8, 3), torch.float32, zeros=True)
    assert seen == [((16, 4, 2), torch.float32, 0.25),
                    ((8,), torch.bfloat16, 0.02),
                    ((8, 3), torch.float32, 0.5),
                    ((8, 3), torch.float32, None)]


# ------------------------------------------------------------ shared layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_embed_unembed_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (rng.standard_normal(32) * 0.1).astype(np.float32)
    table = (rng.standard_normal((50, 32)) * 0.3).astype(np.float32)
    ids = rng.integers(0, 50, (2, 5)).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    got = common.rmsnorm(torch.from_numpy(scale), tx, 1e-6)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    e = common.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                            tdt)
    je = jcommon.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jdt)
    np.testing.assert_array_equal(e.float().numpy(),
                                  np.asarray(je.astype(jnp.float32)))
    for cap in (0.0, 2.0):
        lg = common.unembed(torch.from_numpy(table), tx, softcap=cap)
        jl = jcommon.unembed(jnp.asarray(table), jx, softcap=cap)
        assert lg.dtype == torch.float32
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        if cap:
            assert float(lg.abs().max()) <= cap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    """sin/cos in f32 at positions up to 500k, the rotation in f32 and
    cast back."""
    pos = np.array([0, 1, 7, 4095, 524287], np.int32)
    s, c = common.rope_freqs(16, 1e6, torch.from_numpy(pos))
    js, jc = jcommon.rope_freqs(16, 1e6, jnp.asarray(pos))
    assert s.dtype == torch.float32 and s.shape == (5, 8)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    x = np.random.default_rng(1).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = common.apply_rope(torch.from_numpy(x).to(tdt), s, c)
    want = jcommon.apply_rope(jnp.asarray(x).astype(jdt), js, jc)
    assert got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 255, 256, 300, 4096])
def test_moe_capacity_equals_jax(n):
    for arch in ("qwen2-moe-a2.7b", "llama4-maverick-400b-a17b"):
        for smoke in (True, False):
            cfg = reg.get_config(arch, smoke=smoke)
            jcfg = jreg.get_config(arch, smoke=smoke)
            assert moe.capacity(cfg, n) == jmoe.capacity(jcfg, n)
    assert moe.capacity(reg.get_config("qwen2-moe-a2.7b"), 300) % 256 == 0


def test_moe_drops_past_capacity_as_jax():
    """At capacity factor 0.3 (2 slots an expert for 24 tokens x top-2
    over 8 experts) the port's dispatch keeps the first C assignments of
    each expert (token-major, then k) and drops the rest, as the JAX
    scatter with mode="drop": the same output and aux."""
    jcfg = jreg.get_config("qwen2-moe-a2.7b", smoke=True).replace(
        dtype=jnp.float32, capacity_factor=0.3, n_shared_experts=0)
    cfg = reg.get_config("qwen2-moe-a2.7b", smoke=True).replace(
        dtype=torch.float32, capacity_factor=0.3, n_shared_experts=0)
    p = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(
        np.float32)
    want, jaux = jmoe.moe_apply(p, jnp.asarray(x), jcfg)
    layer = moe.MoE(cfg, common.empty_init("cpu"))
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()})
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x))
    assert moe.capacity(cfg, 24) < 24 * cfg.top_k / cfg.n_experts
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux["moe_balance"]),
                               float(jaux["moe_balance"]), rtol=1e-6)


# ------------------------------------------------------------ shim, imports

def test_matvec_shim_reexports_the_operators():
    """The JAX shim's names, less ``rowwise_matvec_specs`` (not ported),
    each the port's operator object."""
    assert set(port_matvec.__all__) == set(jax_matvec.__all__) - {
        "rowwise_matvec_specs"}
    for name in port_matvec.__all__:
        assert getattr(port_matvec, name) is getattr(est.operators, name)


def test_import_check_covers_models_configs_data():
    """tests/test_torch_plan.py's no-JAX check walks src/repro_torch
    recursively: the new subpackages' modules are among its files, and
    none of them imports jax or repro."""
    import ast
    pkg = ROOT / "src" / "repro_torch"
    files = set(pkg.rglob("*.py"))
    for sub, names in (("models", ["common.py", "attention.py", "mlp.py",
                                   "moe.py", "ssm.py", "blocks.py",
                                   "model.py", "convert.py"]),
                       ("configs", ["registry.py", "shapes.py",
                                    "gemma3_1b.py", "llama4_maverick.py"]),
                       ("data", ["synthetic.py"]),
                       ("estimators", ["matvec.py"])):
        for name in names:
            path = pkg / sub / name
            assert path in files, path
            for node in ast.walk(ast.parse(path.read_text())):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "jaxlib", "repro")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a device the entry points ask for the card and raise where
    there is none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reg.get_config("qwen2.5-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA device"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA device"):
        synth_batch(cfg, DataConfig(), 0)
    params = jax.device_get(JM.init_model(
        jax.random.PRNGKey(0), jreg.get_config("qwen2.5-3b", smoke=True)))
    with pytest.raises(RuntimeError, match="CUDA device"):
        from_jax_params(params, cfg)
