"""CPU twins of `repro_torch.checkpoint` against `repro.checkpoint`
(tests/test_substrates.py's checkpoint tests), plus what the port adds:
bf16 leaves round-trip bitwise, an async save holds the values of its
call (not of a later in-place update), a whole train state (the model,
the stacked optimizer state, the step) restores bitwise onto the CPU,
and the optimizer's leaves carry the JAX package's file names."""
from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.registry import get_config as jax_config
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import from_jax_train_state
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, init_train_state


def _tiny_state():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3)},
            "opt": {"count": torch.tensor(5, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _same(a, b) -> bool:
    if isinstance(a, torch.nn.Module):
        sa, sb = dict(a.named_parameters()), dict(b.named_parameters())
        return set(sa) == set(sb) and all(_same(sa[k], sb[k]) for k in sa)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.detach().reshape(-1).view(torch.uint8),
                            b.detach().reshape(-1).view(torch.uint8)))


def test_checkpoint_roundtrip(tmp_path):
    st = _tiny_state()
    ckpt.save(tmp_path, st, 7)
    got, step = ckpt.restore(tmp_path, _meta(st), device="cpu")
    assert step == 7
    assert _same(got, st)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 7
    assert {x["name"]: x["dtype"] for x in manifest["leaves"]} == {
        "params__w": "float32", "opt__count": "int32", "step": "int32"}


def test_checkpoint_latest_and_atomicity(tmp_path):
    st = _tiny_state()
    ckpt.save(tmp_path, st, 1)
    ckpt.save(tmp_path, st, 3)
    (tmp_path / ".tmp_step_00000009_123").mkdir()   # crashed partial write
    assert ckpt.latest_step(tmp_path) == 3
    assert ckpt.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "absent", st, device="cpu")


def test_checkpoint_async(tmp_path):
    st = _tiny_state()
    t = ckpt.save_async(tmp_path, st, 11)
    t.join(timeout=30)
    assert ckpt.latest_step(tmp_path) == 11
    ckpt.wait_pending()


def test_checkpoint_shape_mismatch_raises(tmp_path):
    st = _tiny_state()
    ckpt.save(tmp_path, st, 1)
    bad = _meta(st)
    bad["params"]["w"] = torch.empty((3, 3), device="meta")
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, bad, device="cpu")


def test_bf16_leaf_roundtrips_bitwise(tmp_path):
    """numpy has no bf16: the bits go to disk as uint16, the manifest says
    bfloat16, and every value (signed zeros, inf, NaN, subnormals) comes
    back bit for bit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32)) \
        .to(torch.bfloat16)
    x[:6] = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                          float("nan"), 1e-40]).to(torch.bfloat16)
    st = {"params": {"x": x}, "step": torch.tensor(1, dtype=torch.int32)}
    ckpt.save(tmp_path, st, 1)
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json")
                          .read_text())
    assert {"name": "params__x", "shape": [64], "dtype": "bfloat16"} in \
        manifest["leaves"]
    assert np.load(tmp_path / "step_00000001" / "params__x.npy").dtype == \
        np.uint16
    got, _ = ckpt.restore(tmp_path, st, device="cpu")
    assert got["params"]["x"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["x"].view(torch.int16),
                       x.view(torch.int16))


def test_async_save_holds_the_values_of_its_call(tmp_path):
    """save_async copies every leaf on the caller's thread: an in-place
    update right after it (the next step's) does not reach the file."""
    st = _tiny_state()
    w0 = st["params"]["w"].clone()
    big = {"params": {"w": st["params"]["w"],
                      "pad": torch.zeros(4_000_000)}, "step": st["step"]}
    t = ckpt.save_async(tmp_path, big, 2)
    st["params"]["w"].add_(100.0)
    big["params"]["pad"].fill_(1.0)
    t.join(timeout=60)
    got, _ = ckpt.restore(tmp_path, _meta(big), device="cpu")
    assert torch.equal(got["params"]["w"], w0)
    assert not got["params"]["pad"].any()


def test_train_state_roundtrips_onto_the_cpu(tmp_path):
    """A whole train state (the model's per-layer parameters, the stacked
    adafactor state, the step) saved and restored: a new Model, its
    leaves parameters again, every tensor bitwise; the state it was
    restored from is untouched."""
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name="adafactor"))
    st = init_train_state(cfg, tcfg, generator=torch.Generator()
                          .manual_seed(0), device="cpu")
    for leaf in st["opt"]["f"]["blocks"]["attn"]["wq"].values():
        leaf.normal_()
    st["step"].fill_(3)
    ckpt.save(tmp_path, st, 3)
    got, step = ckpt.restore(tmp_path, st, device="cpu")
    assert step == 3 and isinstance(got["params"], Model)
    assert got["params"] is not st["params"]
    assert all(isinstance(p, torch.nn.Parameter) and p.requires_grad
               for p in got["params"].parameters())
    assert _same(got, st)
    assert got["opt"]["f"]["blocks"]["attn"]["wq"]["vc"].shape == \
        st["opt"]["f"]["blocks"]["attn"]["wq"]["vc"].shape


def test_restore_defaults_to_the_card(tmp_path):
    st = _tiny_state()
    ckpt.save(tmp_path, st, 1)
    if torch.cuda.is_available():
        got, _ = ckpt.restore(tmp_path, st)
        assert got["step"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device"):
            ckpt.restore(tmp_path, st)


def test_optimizer_leaves_keep_the_jax_names(tmp_path):
    """The JAX package's checkpoint of an adamw train state and the
    port's of the same state carried across: the optimizer's and the
    step's files have the same names and the same bits; each of the
    port's per-layer parameter files is a layer of the JAX stacked one."""
    jcfg = jax_config("qwen2.5-3b", smoke=True).replace(dtype=jnp.float32)
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype=torch.float32)
    jt = JTrainConfig(opt=JOptConfig(name="adamw"))
    jst = jax_init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    jst["opt"]["m"]["blocks"]["attn"]["wq"] = \
        jst["opt"]["m"]["blocks"]["attn"]["wq"] + 1.5
    jdir = jckpt.save(tmp_path / "jax", jst, 0)
    st = from_jax_train_state(jax.device_get(jst), cfg,
                              TrainConfig(opt=OptConfig(name="adamw")),
                              device="cpu")
    tdir = ckpt.save(tmp_path / "torch", st, 0)

    def names(d):
        return {x["name"] for x in json.loads(
            (d / "manifest.json").read_text())["leaves"]}
    jn, tn = names(jdir), names(tdir)
    shared = {n for n in jn if not n.startswith("params__")}
    assert shared and shared <= tn
    assert {n for n in tn if not n.startswith("params__")} == shared
    for n in shared:
        a, b = np.load(jdir / f"{n}.npy"), np.load(tdir / f"{n}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    stacked = np.load(jdir / "params__blocks__attn__wq.npy")
    for i in range(cfg.n_layers):
        layer = np.load(tdir / f"params__blocks__{i}__attn__wq.npy")
        assert np.array_equal(layer, stacked[i])
