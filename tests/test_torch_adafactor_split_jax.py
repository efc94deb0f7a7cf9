"""Adafactor on a grid, its factored moments in the sharding rules' blocks,
against the JAX package's jitted step on a fake-device 2x2 mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a
subprocess), laid out as the JAX launcher lays it out (``param_shardings``
of the parameters and of the optimizer state, in and out).

The port's 2x2 grid of gloo ranks on the CPU (`test_torch_ranks
.split_step`) takes STEPS steps of the split mesh step
(`sharding.layout.mesh_step`) on gemma3-1b's smoke config at f32
activations with the logdet aux, from the JAX state carried across
(`models.convert.from_jax_train_state`), on one seeded batch; the JAX
step takes the same steps.  Two steps, so that Adafactor's decay
``1 - c^-0.8`` is not 0 and the moments carry over.  Held:

- every rank's ``vr`` / ``vc`` blocks of the rules' shard shapes, some
  of them split: the moments are never whole on a rank, and no gradient
  is gathered;
- after each step, the moments (gathered whole) within STATE_RTOL of
  each element plus STATE_ATOL of the largest element of their kind,
  and each parameter within MOVE_RTOL of its leaf's largest move (the
  JAX steps' moves summed) plus two f32 spacings a step (each side
  rounds ``p - lr * s`` once a step);
- the first step's metrics within the gates of `_torch_layer_gather`
  (its gradient is held there by
  tests/test_torch_layer_gather_memory.py's Adafactor case, the same
  state and batch), the shared bits (`check_shared_bits`), and the
  collectives equal to `layout.step_plan` (`check_plan`), whose all_sums
  are an AdamW step's plus, per JAX leaf, the update's sums counted here
  from the JAX rules' specs: a factored leaf's rows where its last dim
  is split, its columns with ``vr``'s mean where its second to last is,
  and the RMS clip's where any dim is; the broadcasts an AdamW step's
  (the parameters' gathers alone);
- a 2x2 `launch.train` run with ``--optimizer adafactor`` whose
  checkpoint, restored onto a 2x1 grid, is bitwise the saved blocks
  there (`rank_restore`), and whose ranks built at most the largest
  parameter whole at once (`rank_main`'s ``build_whole_peak_bytes``).

STATE_RTOL and STATE_ATOL are `_torch_train_twins`'s for one device.
MOVE_RTOL: the two frameworks' gradients differ by rounding, up to
GRAD_TOL (1e-5) of the largest element; Adafactor scales each element by
its row's and column's RMS, so an element's move differs by about that
share of its leaf's step (an element whose own move is small differs by
much more of that move), and the grid's means add in another order
(1e-7 of each).  1e-4 of the leaf's largest move leaves a margin of
several times the difference seen.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import pytest

import jax
import torch

from repro.configs.registry import get_config as jax_config
from repro.sharding import rules as JR

from repro_torch.configs import get_config
from repro_torch.core.mesh import run_ranks
from repro_torch.launch import train as T
from repro_torch.launch.mesh import GridMesh
from repro_torch.models.convert import flatten, unstacked
from repro_torch.optim import OptConfig
from repro_torch.sharding import layout
from repro_torch.sharding.rules import Sharding, batch_spec
from repro_torch.train import TrainConfig

import _torch_layer_gather as LG
from _subproc import run_with_devices
from test_torch_ranks import split_step

ARCH, STEPS = "gemma3-1b", 2
OPT = {"lr": 1e-2, "warmup": 1}
KW = {"optimizer": "adafactor", "logdet_reg": 0.05, "opt": OPT}
STATE_RTOL, STATE_ATOL = 1e-3, 1e-5
MOVE_RTOL = 1e-4
LAUNCH_ARGV = ["--arch", ARCH, "--steps", "3", "--batch", "4", "--seq", "8",
               "--lr", "3e-3", "--ckpt-every", "2", "--log-every", "100",
               "--device", "cpu", "--optimizer", "adafactor"]

JAX_CODE = """
import pickle
jax.config.update("jax_enable_x64", False)
from jax.sharding import NamedSharding
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh_like
from repro.optim.optimizers import OptConfig
from repro.sharding import hints
from repro.sharding.rules import batch_spec, param_shardings
from repro.train.step import TrainConfig, make_train_step

with open({path!r}, "rb") as f:
    arch, state, batch, kw, steps = pickle.load(f)
mesh = make_mesh_like("2x2")
kw = dict(kw)
tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer"), **kw.pop("opt")),
                   **kw)
cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
hints.configure(cfg, mesh)
sh = {{"params": param_shardings(state["params"], cfg, mesh),
       "opt": param_shardings(state["opt"], cfg, mesh),
       "step": NamedSharding(mesh, jax.sharding.PartitionSpec())}}
bsh = {{k: NamedSharding(mesh, s) for k, s in batch_spec(
    cfg, mesh, kind="train", batch=batch["tokens"].shape[0]).items()}}
out = []
with mesh:
    st = jax.device_put(state, sh)
    b = jax.device_put(batch, bsh)
    step = jax.jit(make_train_step(cfg, tcfg), in_shardings=(sh, None),
                   out_shardings=(sh, None))
    for _ in range(steps):
        st, metrics = step(st, b)
        out.append({{"state": jax.device_get(st),
                     "metrics": {{k: float(v) for k, v in metrics.items()}}}})
with open({path!r} + ".out", "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("adafactor_split")
    # the JAX optimizer's init does not read the learning rate
    np_state, batch = LG._case(ARCH, {k: v for k, v in KW.items()
                                      if k != "opt"})
    path = str(d / "case.pkl")
    with open(path, "wb") as f:
        pickle.dump((ARCH, np_state, batch, KW, STEPS), f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=600)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    cases = {"adafactor": (ARCH, np_state, batch, dict(KW, steps=STEPS))}
    ranks = run_ranks(split_step, 4, backend="gloo", device="cpu",
                      timeout=600, args=("2x2", cases))
    launch = run_ranks(T.rank_main, 4, backend="gloo", device="cpu",
                       timeout=600, args=(LAUNCH_ARGV + [
                           "--mesh", "2x2", "--ckpt-dir", str(d / "grid")],
                           1, True, None, False, torch.float32))
    restored = run_ranks(T.rank_restore, 2, backend="gloo", device="cpu",
                         timeout=600, args=(LAUNCH_ARGV + [
                             "--ckpt-dir", str(d / "2x1")], "2x1",
                             str(d / "grid"), 2, 1, torch.float32))
    return {"cases": cases, "np_state": np_state, "jax": jax_out,
            "ranks": ranks, "launch": launch, "restored": restored,
            "dir": d}


def _rule_shapes(ranks, name="adafactor"):
    """(the port's 2x2 shardings on a shape-only grid, the whole shapes)
    of the case's state by `layout.flat` path joined with dots."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    tcfg = TrainConfig(opt=OptConfig(name="adafactor"))
    shapes = layout.state_shapes(cfg, tcfg)
    whole = {".".join(p): tuple(t.shape)
             for p, t in layout.flat(shapes).items()}
    out = []
    for r in ranks:
        grid = GridMesh(("data", "model"), (2, 2),
                        rank=2 * r["coords"]["data"] + r["coords"]["model"])
        sh = layout.state_shardings(shapes, cfg, grid, "adafactor")
        out.append({".".join(p): s for p, s in layout.flat(sh).items()})
    return out, whole


def test_the_moments_are_in_the_rules_blocks(runs):
    ranks = [r["adafactor"] for r in runs["ranks"]]
    rules, whole = _rule_shapes(ranks)
    split = 0
    for r, sh in zip(ranks, rules):
        assert set(r["shapes"]) == set(whole)
        for k, shape in r["shapes"].items():
            assert shape == layout.shard_shape(whole[k], sh[k]), (k, shape)
            if k.rsplit(".", 1)[-1] in ("vr", "vc"):
                split += shape != whole[k]
    assert split > 0


def test_each_step_is_the_jax_meshs_step(runs):
    lead = runs["ranks"][0]["adafactor"]
    assert lead["coords"] == {"data": 0, "model": 0}
    start = unstacked(runs["np_state"]["params"])
    moved = {k: np.zeros(np.shape(v)) for k, v in start.items()}
    prev = start
    for i, (got, ref) in enumerate(zip(lead["states"], runs["jax"])):
        jstate = ref["state"]
        assert int(got["step"]) == int(jstate["step"]) == i + 1
        # the moments, leaf for leaf
        want = flatten(jstate["opt"])
        assert {"opt." + k for k in want} == {
            k for k in got if k.startswith("opt.")}
        scale = {}
        for k, v in want.items():
            kind = k.rsplit(".", 1)[-1]
            scale[kind] = max(scale.get(kind, 0.0), float(np.abs(v).max()))
        for k, v in want.items():
            g = np.asarray(got["opt." + k], np.float64)
            v = np.asarray(v, np.float64)
            assert g.shape == v.shape, k
            tol = STATE_RTOL * np.abs(v) + STATE_ATOL * scale[
                k.rsplit(".", 1)[-1]]
            assert (np.abs(g - v) <= tol).all(), (i, k, np.abs(g - v).max())
        # each parameter's move from the start
        jp = unstacked(jstate["params"])
        for k, v in jp.items():
            moved[k] = moved[k] + np.abs(np.asarray(v, np.float64)
                                         - np.asarray(prev[k], np.float64))
        prev = jp
        for k, v in jp.items():
            v = np.asarray(v, np.float64)
            g = np.asarray(got["params." + k], np.float64)
            ulp = np.spacing(np.abs(v.astype(np.float32))).astype(np.float64)
            tol = MOVE_RTOL * moved[k].max() + 2 * (i + 1) * ulp
            err = np.abs(g - v)
            assert (err <= tol).all(), (i, k, err.max(), moved[k].max())
        assert any((moved[k] > 0).any() for k in moved)
    jm = runs["jax"][0]["metrics"]
    for r in runs["ranks"]:
        for k, v in jm.items():
            rtol = LG.METRIC_RTOL.get(k, LG.METRIC_RTOL["default"])
            assert abs(r["adafactor"]["metrics"][k] - v) <= rtol * abs(v), k


def test_the_ranks_share_their_bits(runs):
    LG.check_shared_bits(runs, "adafactor")


def _jax_factored_sums() -> tuple:
    """(all_sums, bytes) of the Adafactor update on a rank of the 2x2
    grid, from the JAX rules' specs of the JAX parameter tree."""
    jcfg = jax_config(ARCH, smoke=True)
    _, _, params = LG.jax_params(ARCH)
    fm = type("FakeMesh", (), {"shape": {"data": 2, "model": 2},
                               "axis_names": ("data", "model")})()
    specs = JR.param_specs(params, jcfg, JR.make_rules(jcfg, fm), fm)
    count, nbytes = 0, 0
    for leaf, spec in zip(jax.tree.leaves(params), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JR.P))):
        shape = list(leaf.shape)
        split = {}
        for d, e in enumerate(spec):
            n = 1 if e is None else math.prod(
                fm.shape[a] for a in (e if isinstance(e, tuple) else (e,)))
            shape[d] //= n
            if n > 1:
                split[d - len(shape)] = n
        if len(shape) >= 2:
            if -1 in split:
                count += 1
                nbytes += math.prod(shape[:-1]) * 4
            if -2 in split:
                count += 1
                nbytes += math.prod(shape[:-2]) * (shape[-1] + 1) * 4
        if split:
            count += 1
            nbytes += 4
    return count, nbytes


def test_the_collectives_are_the_plan_and_gather_no_gradient(runs):
    LG.check_plan(runs, "adafactor")
    count, nbytes = _jax_factored_sums()
    assert count > 0
    cfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    _, _, batch, _ = runs["cases"]["adafactor"]
    for r in (x["adafactor"] for x in runs["ranks"]):
        grid = GridMesh(("data", "model"), (2, 2),
                        rank=2 * r["coords"]["data"] + r["coords"]["model"])
        tcfg = TrainConfig(opt=OptConfig(name="adamw"), logdet_reg=0.05)
        shapes = layout.state_shapes(cfg, tcfg)
        sh = layout.state_shardings(shapes, cfg, grid, "adamw")
        bsh = {k: Sharding(grid, s) for k, s in batch_spec(
            cfg, grid, kind="train", batch=batch["tokens"].shape[0]).items()}
        rows = layout.batch_rows({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, bsh)
        adamw = layout.step_plan(cfg, tcfg, sh, bsh, shapes["params"],
                                 rows=rows)
        plan = r["plan"]
        assert plan["broadcast"] == adamw["broadcast"]
        assert plan["bytes"] == adamw["bytes"]
        assert plan["gathered"] == adamw["gathered"]
        assert plan["all_sum"] == adamw["all_sum"] + count
        assert plan["all_sum_bytes"] == adamw["all_sum_bytes"] + nbytes


def test_a_2x2_checkpoint_restores_onto_2x1_bitwise(runs):
    launch, restored = runs["launch"], runs["restored"]
    largest = max(
        t.numel() * t.element_size() for t in layout.state_shapes(
            get_config(ARCH, smoke=True), TrainConfig())["params"]
        .parameters())
    for r in launch:
        assert 0 < r["build_whole_peak_bytes"] <= largest
        assert r["build_peak_bytes"] is None            # no card
        assert len(r["losses"]) == 3 and np.isfinite(r["losses"]).all()
    rules, whole = _rule_shapes(launch)
    for r, sh in zip(launch, rules):
        for k, a in r["blocks"].items():
            assert a.shape == layout.shard_shape(whole[k], sh[k]), k
    assert [r["coords"] for r in restored] == [{"data": 0, "model": 0},
                                               {"data": 1, "model": 0}]
    for r in restored:
        assert r["at"] == 2 and r["restored_bitwise"], r["coords"]
        assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 1
    assert restored[0]["losses"] == restored[1]["losses"]
    split = sum(a.shape != whole[k] for k, a in restored[0]["restored"]
                .items() if k.rsplit(".", 1)[-1] in ("vr", "vc"))
    assert split > 0
