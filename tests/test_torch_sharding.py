"""CPU twins of `repro_torch.sharding` against `repro.sharding`: the JAX
package's sharding tests (tests/test_sharding.py) on the port, and the
port's specs held against the JAX rules on the same configs and meshes.

The port's model keeps one module per layer where the JAX tree stacks
layers, so a port parameter's spec is the JAX stacked leaf's spec with
its leading stack entries (all None) dropped; the optimizer state keeps
the JAX layout, so its specs are the JAX ones.  Full-size configs are
built on the meta device (nothing allocated); the JAX trees by
``jax.eval_shape``.  Meshes are the JAX tests' `FakeMesh` (shape only),
which both packages take."""
from __future__ import annotations

import functools
import math

import numpy as np
import pytest

import jax
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.sharding import hints as jhints
from repro.sharding import rules as JR
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch.configs import get_config
from repro_torch.models import Model, cache_specs
from repro_torch.models.common import empty_init
from repro_torch.optim import OptConfig, get_optimizer, jax_leaves
from repro_torch.sharding import hints
from repro_torch.sharding.rules import (PartitionSpec as P, batch_spec,
                                        cache_shardings, logical_axes_for,
                                        make_rules, param_specs)


class FakeMesh:
    """Just enough Mesh interface for the pure spec functions."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3,
          "2x2": FakeMesh({"data": 2, "model": 2}),
          "1x1": FakeMesh({"data": 1, "model": 1})}
TWIN_ARCHS = ["qwen2.5-3b", "qwen2-moe-a2.7b", "mamba2-370m", "zamba2-7b"]
# the twins, and the arch whose full width the card lays out on a grid
SPEC_ARCHS = TWIN_ARCHS + ["gemma3-1b"]
ALL_ARCHS = TWIN_ARCHS + ["gemma3-1b", "qwen1.5-4b", "phi3-mini-3.8b",
                          "llama4-maverick-400b-a17b", "whisper-tiny",
                          "llama-3.2-vision-11b"]


def norm(entry):
    """Spec entries may be 'x' or ('x',) -- normalize to a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def canon(spec):
    """A spec as a tuple of entry tuples (JAX may spell ('x',) as 'x')."""
    return tuple(None if e is None else norm(e) for e in spec)


def _opt(arch):
    return "adafactor" if arch == "qwen2-moe-a2.7b" else "adamw"


@functools.lru_cache(maxsize=None)
def port_state(arch: str, opt: str):
    """The port's full-size train state on the meta device."""
    cfg = get_config(arch)
    model = Model(cfg, empty_init(torch.device("meta")))
    state = {"params": model,
             "opt": get_optimizer(OptConfig(name=opt))[0](model),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    return cfg, state


@functools.lru_cache(maxsize=None)
def jax_state(arch: str, opt: str):
    cfg = jax_config(arch)
    tcfg = JTrainConfig(opt=JOptConfig(name=opt))
    return cfg, jax.eval_shape(lambda k: jax_init_train_state(k, cfg, tcfg),
                               jax.random.PRNGKey(0))


def jax_flat(tree):
    """{"a.b.c": leaf} of a JAX tree (specs are leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(port_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# the JAX package's tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TWIN_ARCHS)
def test_every_param_and_opt_leaf_has_a_spec(arch):
    cfg, state = port_state(arch, _opt(arch))
    rules = make_rules(cfg, MESH)
    specs = param_specs(state, cfg, rules, MESH)   # must not raise
    n_leaves = sum(1 for _ in state["params"].parameters()) + \
        len(port_flat(state["opt"])) + 1
    flat_s = port_flat(specs)
    assert len(flat_s) == n_leaves
    shapes = port_flat({"params": dict(state["params"].named_parameters()),
                        "opt": state["opt"], "step": state["step"]})
    for key, spec in flat_s.items():
        shape = shapes[key].shape
        for dim, entry in zip(shape, tuple(spec) + (None,) * 8):
            if entry is None:
                continue
            size = int(np.prod([MESH.shape[a] for a in norm(entry)]))
            assert dim % size == 0, (key, shape, spec)


def test_embed_replicated_when_vocab_indivisible():
    cfg = get_config("mamba2-370m")               # vocab 50280, not /16
    model = Model(cfg, empty_init(torch.device("meta")))
    specs = param_specs(model, cfg, make_rules(cfg, MESH), MESH)
    emb = tuple(specs["embed"]) + (None,)
    assert emb[0] is None                          # vocab can't shard on 16


def test_expert_axis_guard():
    cfg = get_config("qwen2-moe-a2.7b")           # 60 experts, not /16
    model = Model(cfg, empty_init(torch.device("meta")))
    specs = param_specs(model, cfg, make_rules(cfg, MESH), MESH)
    we = tuple(specs["blocks.0.moe.we_gate"]) + (None,) * 3   # (E, D, F)
    assert we[0] is None                           # E=60 replicated
    cfg4 = get_config("llama4-maverick-400b-a17b")  # 128 experts /16 ok
    model4 = Model(cfg4, empty_init(torch.device("meta")))
    specs4 = param_specs(model4, cfg4, make_rules(cfg4, MESH), MESH)
    we4 = tuple(specs4["moe_blocks.0.moe.we_gate"]) + (None,) * 3
    assert norm(we4[0]) == ("model",)


def test_batch_spec_small_batch_replicates():
    cfg = get_config("zamba2-7b")
    bs = batch_spec(cfg, MESH, kind="decode", batch=1)
    assert bs["tokens"][0] is None
    bs128 = batch_spec(cfg, MESH, kind="decode", batch=128)
    assert norm(bs128["tokens"][0]) == ("data",)


def test_cache_shardings_decode_never_shards_seq_for_batchful():
    """Divisible batch -> S unsharded (the decode write stays local)."""
    cfg = get_config("qwen1.5-4b")                 # kv=20: heads don't divide
    cs = cache_shardings(cache_specs(cfg, 128, 32768), cfg, MESH)
    entries = tuple(cs["k"]) + (None,) * 5         # (L, B, S, kvh, hd)
    assert entries[2] is None                      # S local
    assert norm(entries[4]) == ("model",)          # hd sharded


def test_cache_shardings_long500k_shards_seq():
    cfg = get_config("zamba2-7b")
    cs = cache_shardings(cache_specs(cfg, 1, 524288), cfg, MESH)
    entries = tuple(cs["super"][1]["k"]) + (None,) * 5
    assert norm(entries[2]) == ("data",)           # S carries data axes


def test_multipod_rules_use_pod_axis():
    cfg = get_config("qwen2.5-3b")
    assert make_rules(cfg, MESH3)["embed"] == ("pod", "data")


def test_unknown_param_raises():
    class K:
        def __init__(self, key):
            self.key = key
    with pytest.raises(ValueError, match="no sharding rule"):
        logical_axes_for((K("mystery_weight"),),
                         torch.empty((4, 4), device="meta"))
    with pytest.raises(ValueError, match="no sharding rule"):
        logical_axes_for(("blocks", "0", "mystery_weight"),
                         torch.empty((4, 4), device="meta"))


# ---------------------------------------------------------------------------
# the port against the JAX rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_specs_equal_the_jax_rules(arch, mesh):
    """Every parameter and optimizer leaf's spec is the JAX spec of its
    JAX leaf (the parameter's without the stack's leading Nones)."""
    fm = MESHES[mesh]
    opt = _opt(arch)
    cfg, state = port_state(arch, opt)
    jcfg, jshapes = jax_state(arch, opt)
    specs = param_specs(state, cfg, make_rules(cfg, fm), fm)
    jspecs = JR.param_specs(jshapes, jcfg, JR.make_rules(jcfg, fm), fm)
    jparams = jax_flat(jspecs["params"])
    n = 0
    for leaf in jax_leaves(state["params"]):
        want = canon(jparams[".".join(leaf.path)])
        depth = len(leaf.lead)
        assert all(e is None for e in want[:depth]), (leaf.path, want)
        for name in leaf.names:
            assert canon(specs["params"][name]) == want[depth:], (
                name, specs["params"][name], want)
            n += 1
    assert n == sum(1 for _ in state["params"].parameters())
    jopt = jax_flat(jspecs["opt"])
    got = port_flat(specs["opt"])
    assert set(got) == set(jopt)
    for k, want in jopt.items():
        assert canon(got[k]) == canon(want), (k, got[k], want)
    assert canon(specs["step"]) == canon(jspecs["step"]) == ()


@pytest.mark.parametrize("mesh", ["16x16", "2x2"])
@pytest.mark.parametrize("arch", SPEC_ARCHS + ["whisper-tiny",
                                  "llama4-maverick-400b-a17b"])
def test_leaf_modes_read_the_jax_rules_model_axis(arch, mesh):
    """How the split step treats each parameter on the model line
    (`sharding.tensor.leaf_modes`), read off the JAX rules: ``split``
    where the JAX spec puts "model" on a dim whose logical axis is heads,
    kv_heads, mlp, vocab, or expert outside the router (the SSM's inner
    leaves and the router stay whole); ``partial`` for an attention's
    wk / wv / bk / bv left whole where its wq splits; ``full``
    otherwise.  `layout.model_block` is the JAX spec without "model",
    and `layout.carries_model` says whether it has "model"."""
    from repro_torch.sharding import layout, tensor
    from repro_torch.sharding.rules import param_shardings
    fm = MESHES[mesh]
    cfg, state = port_state(arch, "adamw")
    jcfg, jshapes = jax_state(arch, "adamw")
    rules = JR.make_rules(jcfg, fm)
    jleaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jshapes["params"])[0]:
        axes = JR.logical_axes_for(path, leaf)
        spec = canon(JR._spec_from_axes(axes, rules, fm, leaf.shape))
        jleaves[".".join(str(k.key) for k in path)] = (
            axes, spec + (None,) * (len(axes) - len(spec)))
    want = {}
    for leaf in jax_leaves(state["params"]):
        axes, spec = jleaves[".".join(leaf.path)]
        depth = len(leaf.lead)
        for name in leaf.names:
            last = name.rpartition(".")[2]
            split = any(
                "model" in norm(e) and (ax in ("heads", "kv_heads", "mlp",
                                               "vocab")
                                        or (ax == "expert"
                                            and last != "router"))
                for ax, e in zip(axes[depth:], spec[depth:]))
            want[name] = (split, tuple(spec[depth:]))
    modes = tensor.leaf_modes(param_shardings(state["params"], cfg, fm))
    assert set(modes) == set(want)
    for name, (split, spec) in want.items():
        prefix, _, last = name.rpartition(".")
        partial = (last in ("wk", "wv", "bk", "bv") and not split
                   and want.get(f"{prefix}.wq", (False,))[0])
        assert modes[name] == (tensor.SPLIT if split else tensor.PARTIAL
                               if partial else tensor.FULL), name
    for name, sh in param_shardings(state["params"], cfg, fm).items():
        spec = want[name][1]
        assert layout.carries_model(sh) == any("model" in norm(e)
                                               for e in spec), name
        inner = tuple(tuple(a for a in norm(e) if a != "model") or None
                      for e in spec)
        got = canon(layout.model_block(sh).spec)
        assert got + (None,) * (len(inner) - len(got)) == inner, name
    split = {k for k, v in modes.items() if v == tensor.SPLIT}
    # what each mesh splits: on 2x2 every arch's q heads (its kv heads
    # where they divide), mlp and vocab; on 16x16 gemma3's 4 heads stay
    # whole, its mlp and vocab split
    if arch == "gemma3-1b":
        assert ("blocks.0.attn.wq" in split) == (mesh == "2x2")
        assert {"embed", "blocks.0.mlp.w_down"} <= split
        assert modes["blocks.0.attn.wk"] == (
            tensor.PARTIAL if mesh == "2x2" else tensor.FULL)
    if arch == "mamba2-370m":
        # the SSM blocks compute alike on the model line (50280 rows do not
        # divide 16 ways)
        assert split == ({"embed"} if mesh == "2x2" else set())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_make_rules_equal_the_jax_rules(arch, mesh):
    fm = MESHES[mesh]
    assert make_rules(get_config(arch), fm) == \
        JR.make_rules(jax_config(arch), fm)
    assert make_rules(get_config(arch), fm, fsdp=False) == \
        JR.make_rules(jax_config(arch), fm, fsdp=False)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-tiny",
                                  "llama-3.2-vision-11b", "zamba2-7b"])
def test_batch_spec_equals_the_jax_rules(arch, kind):
    for fm in MESHES.values():
        for batch in (1, 4, 128, None):
            got = batch_spec(get_config(arch), fm, kind=kind, batch=batch)
            want = JR.batch_spec(jax_config(arch), fm, kind=kind,
                                 batch=batch)
            assert {k: canon(v) for k, v in got.items()} == \
                {k: canon(v) for k, v in want.items()}, (fm.shape, batch)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,batch,seq", [
    ("qwen1.5-4b", 128, 32768), ("zamba2-7b", 1, 524288),
    ("zamba2-7b", 128, 32768), ("mamba2-370m", 4, 64),
    ("llama4-maverick-400b-a17b", 128, 32768), ("gemma3-1b", 1, 524288),
    ("whisper-tiny", 32, 448), ("llama-3.2-vision-11b", 128, 32768)])
def test_cache_shardings_equal_the_jax_rules(arch, batch, seq, mesh):
    """On the port's `cache_specs` against the JAX rules on JAX's (the
    same tree, shape for shape)."""
    fm = MESHES[mesh]
    got = cache_shardings(cache_specs(get_config(arch), batch, seq),
                          get_config(arch), fm)
    jcfg = jax_config(arch)
    want = JR.cache_shardings(JM.cache_specs(jcfg, batch, seq), jcfg, fm)
    gl = [canon(s) for s in jax.tree.leaves(
        got, is_leaf=lambda x: isinstance(x, P))]
    wl = [canon(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert gl == wl


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_hints_table_equals_the_jax_table(arch, mesh):
    fm = MESHES[mesh]
    try:
        for masked in (False, True):
            hints.configure(get_config(arch), fm, kv_masked_write=masked)
            jhints.configure(jax_config(arch), fm, kv_masked_write=masked)
            got = {k: canon(v)
                   for k, v in hints._STATE.hints["specs"].items()}
            want = {k: canon(v)
                    for k, v in jhints._STATE.hints["specs"].items()}
            assert got == want
            assert hints.flag("kv_masked_write") == \
                jhints.flag("kv_masked_write") == masked
        x = torch.ones(2, 3)
        assert hints.constrain(x, "residual") is x
    finally:
        hints.configure(get_config(arch), None)
        jhints.configure(jax_config(arch), None)
    assert not hints.flag("kv_masked_write")


# ---------------------------------------------------------------------------
# the port's layout of a tensor on a grid (sharding.layout), shape only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [P(("data",), ("model",)),
                                  P(("data", "model")), P(None, "model"),
                                  P(("model", "data"), None), P()])
def test_blocks_tile_the_whole_tensor(spec):
    """Every rank's `local_block` of a (8, 6) tensor on a 2x2 grid, put
    back at its `block_slices`, rebuilds the tensor once over."""
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import Sharding
    whole = torch.arange(48.0).reshape(8, 6)
    cover = torch.zeros_like(whole)
    out = torch.full_like(whole, float("nan"))
    for rank in range(4):
        grid = GridMesh(("data", "model"), (2, 2), rank=rank)
        sh = Sharding(grid, spec)
        blk = layout.local_block(whole, sh)
        assert tuple(blk.shape) == layout.shard_shape(whole.shape, sh)
        out[layout.block_slices(whole.shape, sh)] = blk
        cover[layout.block_slices(whole.shape, sh)] += 1
    assert torch.equal(out, whole)
    n = math.prod(layout.shard_shape(whole.shape, sh)) * 4
    assert float(cover.sum()) == n and cover.min() >= 1


def test_collective_plan_counts_each_split_leafs_blocks():
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import Sharding
    grid = GridMesh(("pod", "data", "model"), (2, 4, 1))
    tree = {"a": torch.empty(8, 4, device="meta"),
            "b": {"c.d": torch.empty(8, device="meta")},
            "e": torch.empty((), device="meta"),
            "f": None}
    sh = {"a": Sharding(grid, P(("pod", "data"))),
          "b": {"c.d": Sharding(grid, P("model"))},     # a size-1 axis
          "e": Sharding(grid, P()), "f": None}
    assert layout.collective_plan(sh, tree) == {"broadcast": 8,
                                                "bytes": 8 * 4 * 4}
    assert layout.resident_bytes(sh, tree) == 4 * 4 + 8 * 4 + 4
    assert set(layout.flat(sh)) == {("a",), ("b", "c", "d"), ("e",)}
    assert layout.mesh_of(sh) is grid
    with pytest.raises(ValueError, match="does not split"):
        layout.shard_shape((6,), Sharding(grid, P(("pod", "data"))))


def test_grid_coordinates_and_lines_are_row_major():
    from repro_torch.launch.mesh import (GridMesh, make_mesh_like,
                                         make_production_mesh)
    grid = GridMesh(("pod", "data", "model"), (2, 2, 3))
    assert [grid.coords_of(r) for r in (0, 5, 11)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 0, "data": 1, "model": 2},
        {"pod": 1, "data": 1, "model": 2}]
    assert all(grid.rank_of(grid.coords_of(r)) == r for r in range(12))
    assert grid.line_ranks(("model",), grid.coords_of(4)) == [3, 4, 5]
    assert grid.line_ranks(("pod", "data"), grid.coords_of(4)) == [1, 4, 7,
                                                                   10]
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert prod.coords is None and prod.size == 512
    one = make_mesh_like("1x1", device="cpu")
    assert one.size == 1 and one.coords == {"data": 0, "model": 0}
    assert one.device == torch.device("cpu")


def test_parse_mesh_is_the_one_reading_of_a_spec():
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh_like, parse_mesh
    assert parse_mesh("8") == (("rows",), (8,))
    assert parse_mesh("2X4") == (("data", "model"), (2, 4))
    assert parse_mesh("2x16x16") == (("pod", "data", "model"), (2, 16, 16))
    with pytest.raises(ValueError):
        parse_mesh("2x2x2x2")
    rows = make_mesh_like("1", device="cpu", grid=True)
    assert rows.axis_names == ("rows",) and rows.size == 1
    assert T._mesh("1", "cpu").shape == {"rows": 1}
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh_like("1", device="cpu")      # the rows mesh needs a group


def test_step_plan_adds_the_agreeing_all_sum_on_a_grid():
    """The split step's plan on a 2x2 grid: a root parameter's gather
    (four blocks, once a microbatch), a layer unit's parameter gathered
    for its forward and again for its backward (remat), the nll's
    exchange (two f32s), one reduction of each gradient, the global
    norm's all_sum (one f64) and the one that agrees the step commits
    (one f32); the model line's all_sums of a model whose q heads, mlp
    and vocab the rules split, read off its step; nothing on one rank."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GridMesh, make_mesh_like
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import Sharding, param_shardings
    from repro_torch.train import TrainConfig
    cfg = get_config("gemma3-1b", smoke=True)
    params = {"w": torch.empty(8, 4, device="meta")}
    grid = GridMesh(("data", "model"), (2, 2))
    sh = {"params": {"w": Sharding(grid, P("data", "model"))}}
    bsh = {"tokens": Sharding(grid, P("data"))}
    none = {"model_all_sum": 0, "model_all_sum_bytes": 0}
    assert layout.step_plan(cfg, TrainConfig(), sh, bsh, params) == {
        "broadcast": 4, "bytes": 8 * 4 * 4, "all_sum": 1 + 1 + 1 + 1,
        "all_sum_bytes": 2 * 4 + 8 * 4 * 4 + 8 + 4, "gathered": ["params.w"],
        **none}
    params["blocks.0.w"] = torch.empty(8, 4, device="meta")
    sh["params"]["blocks.0.w"] = Sharding(grid, P("data"))
    assert layout.step_plan(cfg, TrainConfig(), sh, bsh, params) == {
        "broadcast": 4 + 2 * 2, "bytes": 8 * 4 * 4 * 3,
        "all_sum": 1 + 2 + 1 + 1,
        "all_sum_bytes": 2 * 4 + 2 * 8 * 4 * 4 + 8 + 4,
        "gathered": ["params.blocks.0.w", "params.w"], **none}
    # the smoke model by the rules, its q heads, mlp and vocab split on
    # "model": the model line's all_sums, read off the step run shape
    # only.  Each of the 6 layers' attention and MLP sums its output in
    # the forward and again in the recomputation, and its input's gradient
    # in the backward; the lookup sums its rows once; the one 5-token CE
    # chunk exchanges (2 ranks, 3, 2 rows, 5) f32s in its forward and its
    # recomputation and sums its f32 hidden's gradient.  The rank's 2 x 5
    # rows of bf16 activations are 1280 bytes.
    model = Model(cfg, empty_init(torch.device("meta")))
    msh = {"params": param_shardings(model, cfg, grid)}
    with pytest.raises(ValueError, match="rows"):
        layout.step_plan(cfg, TrainConfig(), msh, bsh, model)
    rows = {"tokens": torch.zeros(2, 5, dtype=torch.int32),
            "targets": torch.zeros(2, 5, dtype=torch.int32)}
    plan = layout.step_plan(cfg, TrainConfig(), msh, bsh, model, rows=rows)
    x = 2 * 5 * 64 * 2
    assert plan["model_all_sum"] == 6 * (3 + 3) + 1 + 3
    assert plan["model_all_sum_bytes"] == (
        (6 * 6 + 1) * x + 2 * (2 * 3 * 2 * 5 * 4) + 2 * 5 * 64 * 4)
    del params["blocks.0.w"], sh["params"]["blocks.0.w"]
    one = make_mesh_like("1x1", device="cpu")
    sh1 = {"params": {"w": Sharding(one, P("data", "model"))}}
    bsh1 = {"tokens": Sharding(one, P("data"))}
    assert layout.step_plan(cfg, TrainConfig(), sh1, bsh1, params) == {
        "broadcast": 0, "bytes": 0, "all_sum": 0, "all_sum_bytes": 0,
        "gathered": [], **none}
    assert layout.agree(one, True) is True
    assert layout.agree(one, False) is False


def test_flat_names_a_states_leaves_by_path():
    from repro_torch.sharding import layout
    cfg, state = port_state("gemma3-1b", "adamw")
    got = layout.flat(state)
    names = {".".join(p) for p in got}
    assert {"params." + n for n, _ in state["params"].named_parameters()} \
        <= names
    assert "step" in names and "opt.m.embed" in names
    assert len(names) == sum(1 for _ in state["params"].parameters()) + \
        len(port_flat(state["opt"])) + 1


def test_mesh_step_on_one_rank_raises_and_keeps_the_state():
    """A train step that raises leaves a one-rank grid's state as it was
    (no collective: `agree` is the fault itself there)."""
    from repro_torch.core import mesh as M
    from repro_torch.launch.mesh import make_mesh_like
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import PartitionSpec, Sharding
    grid = make_mesh_like("1x1", device="cpu")
    model = torch.nn.Linear(3, 2)
    state = {"params": model, "opt": {"m": torch.zeros(2, 3)},
             "step": torch.zeros((), dtype=torch.int32)}
    sh = {"params": {n: Sharding(grid, P("data"))
                     for n, _ in model.named_parameters()},
          "opt": {"m": Sharding(grid, P(None, "model"))},
          "step": Sharding(grid, PartitionSpec())}
    before = {k: v.clone() for k, v in layout.flat(state).items()}

    def bad(model, batch):
        raise ValueError("fault")
    M.reset_collective_counts()
    with pytest.raises(ValueError, match="fault"):
        layout.mesh_step(bad, OptConfig(), sh,
                         {"tokens": Sharding(grid, P())})(
            state, {"tokens": torch.ones(2)})
    assert not any(M.collective_counts().values())
    assert all(torch.equal(layout.flat(state)[k], v)
               for k, v in before.items())
    assert all(a is b for a, b in zip(model.parameters(),
                                      state["params"].parameters()))
