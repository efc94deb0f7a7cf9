"""`repro_torch.launch.train` on a 2x2 grid of gloo ranks on the CPU: the
twin of tests/test_launch_integration.py::test_train_cli_multidevice
(gemma3-1b smoke, 30 steps, batch 4, seq 32, lr 3e-3, a checkpoint every
25 steps) at f32 activations, and elastic restore.

The step on the grid splits the batch over the data axis and sums the
ranks' gradients (`sharding.layout.mesh_step`), so it adds in another
order than one rank's product: the grid is held to the one-rank run by
gates, and bitwise where the arithmetic is one rank's alike.

- Gates against the one-rank run: the first step's reduced gradient
  within GRAD_TOL of the largest element of one rank's, its metrics
  within METRIC_RTOL (the phase-14 gates); each step's loss within
  LOSS_RTOL of one rank's; the mean loss over the run's 30 batches falls
  from the first parameters to the grid's last (a single step's loss
  moves with its batch by more than 30 steps of warm-up lr lower it).
- Bitwise: every rank's blocks of the reduced gradient, gathered whole,
  are the same, and the ranks that hold one block of a leaf hold the
  same bits; the grid's step-30
  checkpoint files (written by rank 0 in the one-rank run's format) hold
  every rank's blocks.
- Between steps each rank holds its blocks alone: their shapes are the
  JAX specs' shard shapes.
- One step's collectives equal `sharding.layout.step_plan`: the
  parameters' gathers unit by unit (a layer's again in its backward),
  the gradient's reduction, the nll's all_sum, the global norm's and the
  one on which the ranks agree that the step commits; the plan gathers
  no optimizer leaf.
- The 2x2 run's step-25 checkpoint restores bitwise onto one rank, onto
  a 2x1 grid and onto a 2x2 grid.  The 2x2 grid's five steps end bitwise
  on the 2x2 run's step-30 checkpoint.  The others go on within
  LOSS_RTOL of the run they continue: the 2x1 grid splits the batch as
  the 2x2 one does, but its ranks compute the heads, mlp columns and
  vocab rows that the 2x2 grid's model line splits (`sharding.tensor`)
  whole, so its five steps follow the 2x2 run's losses to rounding, not
  bitwise; one rank's follow the one-rank run's.
- Each rank of a model line reports its share of the heads, the mlp
  columns and the vocab rows (`sharding.tensor.recording`).

LOSS_RTOL comes from f32 rounding: a step's loss sums 128 tokens' terms
in another order (two ranks' partial sums), at most 128 x 2^-24 = 7.6e-6
of it; the parameters' drift over 30 steps adds to that, which the gate
bounds at 1e-5.

The ranks run `repro_torch.launch.train.rank_main` and `rank_restore`
(one CPU thread a rank).  `block_of` cuts tensors by the JAX specs independently
of `sharding.layout.block_slices`, which shards and gathers the port's
state."""
from __future__ import annotations

import functools
import json
import math

import numpy as np
import pytest

import jax
import torch

from repro.configs.registry import get_config as jax_config
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.sharding import rules as JR
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch.configs import get_config
from repro_torch.core.mesh import run_ranks
from repro_torch.launch import train as T
from repro_torch.models import Model
from repro_torch.models.common import empty_init
from repro_torch.optim import global_norm, jax_leaves
from repro_torch.train.step import make_loss_fn

ARGV = ["--arch", "gemma3-1b", "--steps", "30", "--batch", "4", "--seq",
        "32", "--lr", "3e-3", "--ckpt-every", "25", "--device", "cpu"]
RESTORE_AT = 25
F32 = torch.float32
GRAD_TOL = 1e-5
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
LOSS_RTOL = 1e-5


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _norm(entry):
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@functools.lru_cache(maxsize=None)
def jax_specs(dims: tuple):
    """(a (data, model) FakeMesh, {"params.<port name>" / "opt.<path>" /
    "step": the JAX spec's entries for that port leaf on it})."""
    fm = FakeMesh(dict(zip(("data", "model"), dims)))
    jcfg = jax_config("gemma3-1b", smoke=True)
    shapes = jax.eval_shape(lambda k: jax_init_train_state(
        k, jcfg, JTrainConfig(opt=JOptConfig(name="adamw"))),
        jax.random.PRNGKey(0))
    specs = JR.param_specs(shapes, jcfg, JR.make_rules(jcfg, fm), fm)
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        flat[".".join(str(k.key) for k in path)] = tuple(spec)
    out = {"step": flat["step"]}
    model = Model(get_config("gemma3-1b", smoke=True),
                  empty_init(torch.device("meta")))
    for leaf in jax_leaves(model):
        spec = flat["params." + ".".join(leaf.path)]
        for name in leaf.names:
            out[f"params.{name}"] = spec[len(leaf.lead):]
    out.update({k: v for k, v in flat.items() if k.startswith("opt.")})
    return fm, out


def block_of(arr: np.ndarray, spec, coords, fm) -> np.ndarray:
    """The block of a whole array at ``coords`` under a JAX spec."""
    idx = []
    for d, size in enumerate(arr.shape):
        axes = _norm(spec[d]) if d < len(spec) else ()
        n = math.prod(fm.shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * fm.shape[a] + coords[a]
        idx.append(slice(i * size // n, (i + 1) * size // n))
    return arr[tuple(idx)]


def checkpoint_arrays(path) -> dict:
    """A checkpoint's leaves by `rank_main`'s names (numpy; the files
    join a leaf's path with "__")."""
    return {p.stem.replace("__", "."): np.load(p)
            for p in path.iterdir() if p.suffix == ".npy"}


def held_loss(last: dict) -> list:
    """The mean loss over the run's batches of the first parameters and of
    ``last`` (numpy by "params.<name>")."""
    args = T.parser().parse_args(ARGV)
    cfg, first, _, batch_fn, _ = T.build(
        args.arch, smoke=args.smoke, mesh=T._mesh("1x1", "cpu"),
        tcfg=T._tcfg(args), batch=args.batch, seq=args.seq, dtype=F32)
    model = Model(cfg, empty_init(torch.device("cpu")))
    model.load_state_dict({k[len("params."):]: torch.from_numpy(v)
                           for k, v in last.items()
                           if k.startswith("params.")})
    loss_fn = make_loss_fn(cfg, T._tcfg(args))
    with torch.no_grad():
        return [sum(float(loss_fn(p, batch_fn(i))[0])
                    for i in range(args.steps)) / args.steps
                for p in (first["params"], model)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_mesh")
    one = run_ranks(T.rank_main, 1, backend="gloo", device="cpu",
                    timeout=600, args=(ARGV + ["--mesh", "1x1", "--ckpt-dir",
                                               str(d / "one")], 1, True,
                                       None, False, F32))[0]
    grid = run_ranks(
        T.rank_main, 4, backend="gloo", device="cpu", timeout=600,
        args=(ARGV + ["--mesh", "2x2", "--ckpt-dir", str(d / "grid")], 1,
              True, None, False, F32))
    restored = {spec: run_ranks(
        T.rank_restore, n, backend="gloo", device="cpu", timeout=600,
        args=(ARGV + ["--ckpt-dir", str(d / spec)], spec, str(d / "grid"),
              RESTORE_AT, 1, F32))
        for spec, n in (("1x1", 1), ("2x1", 2), ("2x2", 4))}
    last = checkpoint_arrays(d / "grid" / "step_00000030")
    return {"dir": d, "one": one, "grid": grid, "restored": restored,
            "last": last, "held_loss": held_loss(last)}


def _check_blocks(ranks, dims, whole, key="blocks") -> None:
    """Every rank's blocks bitwise the rules' blocks of ``whole``."""
    fm, specs = jax_specs(dims)
    for r in ranks:
        blocks = r[key]
        assert set(blocks) == set(whole)
        for k, spec in specs.items():
            want = block_of(whole[k], spec, r["coords"], fm)
            assert blocks[k].shape == want.shape, (k, r["coords"])
            assert blocks[k].tobytes() == want.tobytes(), (k, r["coords"])


def test_2x2_run_is_within_the_gates_of_the_one_rank_run(runs):
    one = runs["one"]
    assert [r["coords"] for r in runs["grid"]] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    want = one["grads"]
    gmax = max(float(np.abs(v).max()) for v in want.values())
    norm = float(global_norm({k: torch.from_numpy(v)
                              for k, v in want.items()}))
    assert len(one["losses"]) == 30
    for r in runs["grid"]:
        assert set(r["grads"]) == set(want)
        for k, g in r["grads"].items():
            err = float(np.abs(g - want[k]).max())
            assert err <= GRAD_TOL * gmax, (k, err, gmax)
        got_norm = float(global_norm({k: torch.from_numpy(v)
                                      for k, v in r["grads"].items()}))
        metrics = dict(r["grad_metrics"], grad_norm=got_norm)
        for k, v in dict(one["grad_metrics"], grad_norm=norm).items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(metrics[k] - v) <= rtol * abs(v), (k, metrics[k], v)
        err = np.abs(np.array(r["losses"]) - np.array(one["losses"]))
        assert (err <= LOSS_RTOL * np.abs(one["losses"])).all(), err.max()
        assert r["restarts"] == 0
    # the loss falls: the grid's last parameters' mean loss over the run's
    # batches below the first parameters'
    assert runs["held_loss"][1] < runs["held_loss"][0]


def test_2x2_ranks_reduce_the_same_bits_and_hold_the_checkpoints_blocks(runs):
    grid = runs["grid"]
    for r in grid[1:]:
        assert all(r["grads"][k].tobytes() == v.tobytes()
                   for k, v in grid[0]["grads"].items()), r["coords"]
        assert r["losses"] == grid[0]["losses"]
    # rank 0 wrote the step-30 checkpoint from every rank's blocks: each
    # rank's blocks are the files' blocks (so ranks holding one block hold
    # the same bits), and the step is whole
    assert int(runs["last"]["step"]) == 30
    _check_blocks(grid, (2, 2), runs["last"])


def test_2x2_ranks_hold_the_jax_specs_shards(runs):
    fm, specs = jax_specs((2, 2))
    one = runs["one"]["blocks"]
    whole = sum(v.nbytes for k, v in one.items() if k != "step")
    split = 0
    for r in runs["grid"]:
        held = 0
        for k, spec in specs.items():
            if k == "step":
                continue
            shape = list(one[k].shape)
            for d, e in enumerate(spec):
                shape[d] //= math.prod(fm.shape[a] for a in _norm(e))
            assert r["blocks"][k].shape == tuple(shape), (k, spec)
            held += r["blocks"][k].nbytes
            split += k.startswith("params.") and shape != list(one[k].shape)
        assert held < whole
    assert split > 0


def test_2x2_collectives_per_step_equal_the_plan(runs):
    for r in runs["grid"]:
        plan = r["plan"]
        assert r["counts"]["broadcast"] == plan["broadcast"] > 0
        # the nll's exchange, every gradient's reduction, the global
        # norm's and the agreement; the model line's: each of the 6
        # layers' split attention and MLP, their outputs (forward and
        # recomputation) and their inputs' gradients, the vocab-parallel
        # lookup and the one CE chunk's exchange (twice) and gradient
        n_grads = sum(k.startswith("params.") for k in r["blocks"])
        assert plan["model_all_sum"] == 6 * (3 + 3) + 1 + 3
        assert r["counts"]["all_sum"] == plan["all_sum"] == (
            3 + n_grads + plan["model_all_sum"])
        assert r["shares"] == {"heads": [(2, 4, 2 * r["coords"]["model"])],
                               "kv_heads": [(1, 1, None)],
                               "mlp": [(64, 128, 64 * r["coords"]["model"])],
                               "vocab": [(128, 256,
                                          128 * r["coords"]["model"])]}
        assert plan["gathered"] and all(
            k.startswith("params.") for k in plan["gathered"])
    one = runs["one"]
    assert one["counts"] == {"broadcast": 0, "all_sum": 0}
    assert one["plan"] == {"broadcast": 0, "bytes": 0, "all_sum": 0,
                           "all_sum_bytes": 0, "model_all_sum": 0,
                           "model_all_sum_bytes": 0, "gathered": []}


@pytest.mark.parametrize("spec,dims", [("1x1", (1, 1)), ("2x1", (2, 1)),
                                       ("2x2", (2, 2))])
def test_elastic_restore_is_bitwise_the_saved_blocks(runs, spec, dims):
    ranks = runs["restored"][spec]
    saved = checkpoint_arrays(runs["dir"] / "grid"
                              / f"step_{RESTORE_AT:08d}")
    assert all(r["at"] == RESTORE_AT and r["restored_bitwise"]
               for r in ranks)
    _check_blocks(ranks, dims, saved, key="restored")
    if spec == "2x2":
        # the layout it was saved from: bitwise the 2x2 run's end
        _check_blocks(ranks, dims, runs["last"])
        assert all(r["losses"] == runs["grid"][0]["losses"][RESTORE_AT:]
                   for r in ranks)
        return
    # on to step 30 within LOSS_RTOL of the run it continues: the 2x1
    # grid splits the batch as the 2x2 one does, but sums the model
    # line's partial products in one rank; one rank, of the one-rank run
    ref = runs["grid"][0] if spec == "2x1" else runs["one"]
    want = np.array(ref["losses"][RESTORE_AT:])
    for r in ranks:
        err = np.abs(np.array(r["losses"]) - want)
        assert len(err) == 5 and (err <= LOSS_RTOL * want).all(), err
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


def test_2x2_checkpoint_files_hold_the_one_rank_layout(runs):
    d = runs["dir"]
    for step in (RESTORE_AT, 30):
        a = d / "one" / f"step_{step:08d}"
        b = d / "grid" / f"step_{step:08d}"
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir())
        ja = json.loads((a / "manifest.json").read_text())
        jb = json.loads((b / "manifest.json").read_text())
        assert ja == jb
        for name in names:
            if name.endswith(".npy"):
                x, y = np.load(a / name), np.load(b / name)
                assert (x.shape, x.dtype) == (y.shape, y.dtype), name
