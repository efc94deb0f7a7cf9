"""`repro_torch.launch.train` on a 2x2 grid of gloo ranks on the CPU: the
twin of tests/test_launch_integration.py::test_train_cli_multidevice
(gemma3-1b smoke, 30 steps, batch 4, seq 32, lr 3e-3, a checkpoint every
25 steps), and elastic restore.

- Every rank's final state is bitwise the one-rank run's block at the
  rank's coordinates, taken by the JAX rules' specs on a `FakeMesh` of
  the same shape (every rank computes the global program on gathered
  tensors; all ranks and the one-rank run use one CPU thread, so the
  CPU's reductions block alike); the losses are the one-rank run's, and
  the mean loss over the run's 30 batches falls from the first
  parameters to the last (a single step's loss moves with its batch by
  more than 30 steps of warm-up lr lower it).
- Between steps each rank holds its blocks alone: their shapes are the
  JAX specs' shard shapes.
- One step's collectives equal `sharding.layout.step_plan`: the gathers'
  broadcasts and the one all_sum on which the ranks agree that the step
  commits.
- The 2x2 run's step-25 checkpoint restores onto one rank and onto a 2x1
  grid, and the five steps on from there end bitwise where the one-rank
  run ended; the 2x2 run's checkpoint files are the one-rank run's.

The ranks run `repro_torch.launch.train.rank_main` (one CPU thread a
rank) and `tests/test_torch_ranks.py`'s `launch_restore` (spawned; no JAX
import there).  `block_of` cuts the one-rank run's tensors by the JAX
specs independently of `sharding.layout.block_slices`, which shards and
gathers the port's state."""
from __future__ import annotations

import functools
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
from repro_torch.optim import jax_leaves
from repro_torch.train.step import make_loss_fn

from test_torch_ranks import launch_restore

ARGV = ["--arch", "gemma3-1b", "--steps", "30", "--batch", "4", "--seq",
        "32", "--lr", "3e-3", "--ckpt-every", "25", "--device", "cpu"]
RESTORE_AT = 25


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


def held_loss(blocks: dict) -> list:
    """The mean loss over the run's batches of the first parameters and of
    the one-rank run's last ones."""
    args = T.parser().parse_args(ARGV)
    cfg, first, _, batch_fn, _ = T.build(
        args.arch, smoke=args.smoke, mesh=T._mesh("1x1", "cpu"),
        tcfg=T._tcfg(args), batch=args.batch, seq=args.seq)
    last = Model(cfg, empty_init(torch.device("cpu")))
    last.load_state_dict({k[len("params."):]: torch.from_numpy(v)
                          for k, v in blocks.items()
                          if k.startswith("params.")})
    loss_fn = make_loss_fn(cfg, T._tcfg(args))
    with torch.no_grad():
        return [sum(float(loss_fn(p, batch_fn(i))[0])
                    for i in range(args.steps)) / args.steps
                for p in (first["params"], last)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_mesh")
    one = run_ranks(T.rank_main, 1, backend="gloo", device="cpu",
                    timeout=600, args=(ARGV + ["--mesh", "1x1", "--ckpt-dir",
                                               str(d / "one")], 1, True))[0]
    grid = run_ranks(
        T.rank_main, 4, backend="gloo", device="cpu", timeout=600,
        args=(ARGV + ["--mesh", "2x2", "--ckpt-dir", str(d / "grid")], 1,
              True))
    restored = {spec: run_ranks(
        launch_restore, n, backend="gloo", device="cpu", timeout=600,
        args=(spec, str(d / "grid"), RESTORE_AT, ARGV, str(d / spec)))
        for spec, n in (("1x1", 1), ("2x1", 2))}
    return {"dir": d, "one": one, "grid": grid, "restored": restored,
            "held_loss": held_loss(one["blocks"])}


def _check_blocks(ranks, dims, one) -> None:
    fm, specs = jax_specs(dims)
    for r in ranks:
        blocks = r["blocks"]
        assert set(blocks) == set(one["blocks"])
        assert blocks["step"] == one["blocks"]["step"] == 30
        for k, spec in specs.items():
            if k == "step":
                continue
            want = block_of(one["blocks"][k], spec, r["coords"], fm)
            assert blocks[k].shape == want.shape, (k, r["coords"])
            assert blocks[k].tobytes() == want.tobytes(), (k, r["coords"])


def test_2x2_run_is_bitwise_the_one_rank_run(runs):
    one = runs["one"]
    assert [r["coords"] for r in runs["grid"]] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    _check_blocks(runs["grid"], (2, 2), one)
    for r in runs["grid"]:
        assert r["losses"] == one["losses"]
        assert r["restarts"] == 0
    assert len(one["losses"]) == 30
    # the loss falls: the last parameters' mean loss over the run's batches
    # below the first parameters'
    assert runs["held_loss"][1] < runs["held_loss"][0]


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
        assert r["counts"]["broadcast"] == r["plan"]["broadcast"] > 0
        assert r["counts"]["all_sum"] == r["plan"]["all_sum"] == 1
    one = runs["one"]
    assert one["counts"] == {"broadcast": 0, "all_sum": 0}
    assert one["plan"] == {"broadcast": 0, "bytes": 0, "all_sum": 0}


@pytest.mark.parametrize("spec,dims", [("1x1", (1, 1)), ("2x1", (2, 1))])
def test_elastic_restore_is_bitwise(runs, spec, dims):
    ranks = runs["restored"][spec]
    assert all(r["at"] == RESTORE_AT for r in ranks)
    _check_blocks(ranks, dims, runs["one"])


def test_2x2_checkpoint_files_are_the_one_rank_files(runs):
    d = runs["dir"]
    for step in (RESTORE_AT, 30):
        a = d / "one" / f"step_{step:08d}"
        b = d / "grid" / f"step_{step:08d}"
        names = sorted(p.name for p in a.iterdir())
        assert names == sorted(p.name for p in b.iterdir())
        for name in names:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
