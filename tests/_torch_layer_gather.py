"""Shared twin checks of tests/test_torch_layer_gather*.py: the port's
mesh step with its parameters gathered one unit at a time
(`sharding.fsdp`, through `sharding.layout.mesh_step`) on a 2x2 grid of
gloo ranks on the CPU (`test_torch_ranks.split_step`), against the JAX
package's jitted step on a fake-device 2x2 mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, in a
subprocess), laid out as the JAX launcher lays it out (``param_shardings``
in and out, the batch by ``batch_spec``), as
tests/test_torch_split_jax.py does for gemma3 with the aux and qwen2-moe
dropping tokens.

A case is (arch, `TrainConfig` keywords with ``optimizer`` and,
optionally, the config's ``remat``), one step at the smoke config, f32
activations, from the JAX state carried across (`from_jax_train_state`),
on a seeded batch of BATCH x SEQ tokens (MICRO_BATCH with several
microbatches).  The JAX reference gradient is ``jax.grad`` of the JAX
loss, averaged over the microbatches as the step does.

Held (the gates of tests/test_torch_split_jax.py, `check_*`):

- the rank's gradient blocks, gathered whole after the step, within
  GRAD_TOL (per family) of the reference's largest element; with
  ``grad_compression`` each element also within COMPRESSION_ULP of its
  leaf's largest element (each microbatch's gradient is rounded to bf16
  before it is accumulated);
- the step's metrics within METRIC_RTOL of the jitted step's;
- the gathered gradients bitwise alike on every rank, every rank's
  gradient block bitwise its block of them (so the ranks that hold one
  block hold the same bits), and the ranks that hold one block of a
  leaf after the step bitwise alike;
- the step's collectives equal to `layout.step_plan`, which gathers the
  parameters alone: no optimizer leaf and no gradient (Adafactor's
  factored moments are in the rules' blocks too, its means summed over
  the lines that split a leaf).
"""
from __future__ import annotations

import hashlib
import pickle

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import get_optimizer as jax_optimizer
from repro.train.step import TrainConfig as JTrainConfig

from repro_torch.core.mesh import run_ranks
from repro_torch.models.convert import unstacked

from _subproc import run_with_devices
from _torch_train_twins import jax_params
from test_torch_ranks import split_step

GRAD_TOL = {"ssm": 1e-4, "hybrid": 1e-4, "default": 1e-5}
COMPRESSION_ULP = 2.0 ** -7
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
BATCH, MICRO_BATCH, SEQ = 4, 8, 16

JAX_CODE = """
import pickle
jax.config.update("jax_enable_x64", False)
from jax.sharding import NamedSharding
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh_like
from repro.optim.optimizers import OptConfig
from repro.sharding import hints
from repro.sharding.rules import batch_spec, param_shardings
from repro.train.step import TrainConfig, make_loss_fn, make_train_step

with open({path!r}, "rb") as f:
    cases = pickle.load(f)
mesh = make_mesh_like("2x2")
out = {{}}
for name, (arch, state, batch, kw) in cases.items():
    kw = dict(kw)
    over = {{k: kw.pop(k) for k in ("remat",) if k in kw}}
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
    cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32, **over)
    hints.configure(cfg, mesh)
    sh = {{"params": param_shardings(state["params"], cfg, mesh),
           "opt": param_shardings(state["opt"], cfg, mesh),
           "step": NamedSharding(mesh, jax.sharding.PartitionSpec())}}
    bsh = {{k: NamedSharding(mesh, s) for k, s in batch_spec(
        cfg, mesh, kind="train", batch=batch["tokens"].shape[0]).items()}}
    mb = tcfg.microbatches
    n = batch["tokens"].shape[0] // mb
    with mesh:
        st = jax.device_put(state, sh)
        b = jax.device_put(batch, bsh)
        loss = make_loss_fn(cfg, tcfg)
        grad = jax.jit(jax.grad(lambda p, x: loss(p, x)[0]),
                       in_shardings=(sh["params"], None))
        grads = None
        for i in range(mb):
            g = grad(st["params"], {{k: v[i * n:(i + 1) * n]
                                     for k, v in batch.items()}})
            grads = g if grads is None else jax.tree.map(
                lambda a, x: a + x, grads, g)
        grads = jax.tree.map(lambda a: a / mb, grads)
        _, metrics = jax.jit(make_train_step(cfg, tcfg),
                             in_shardings=(sh, None),
                             out_shardings=(sh, None))(st, b)
    out[name] = {{"grads": jax.device_get(grads),
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}}
    hints.configure(cfg, None)
with open({path!r} + ".out", "wb") as f:
    pickle.dump(out, f)
"""


def _case(arch, kw):
    """(the JAX train state's numpy tree, a seeded numpy batch)."""
    jcfg, _, params = jax_params(arch)
    opt = {k: v for k, v in kw.items() if k not in ("optimizer", "remat")}
    jt = JTrainConfig(opt=JOptConfig(name=kw["optimizer"]), **opt)
    state = jax.device_get({"params": params,
                            "opt": jax_optimizer(jt.opt)[0](params),
                            "step": jnp.zeros((), jnp.int32)})
    rng = np.random.default_rng(0)
    b = MICRO_BATCH if kw.get("microbatches", 1) > 1 else BATCH
    tok = rng.integers(0, jcfg.vocab, (b, SEQ)).astype(np.int32)
    return state, {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def run(tmp_dir, cases: dict) -> dict:
    """``cases``: name -> (arch, kw).  The JAX references in one
    subprocess, then the port's 2x2 grid in four gloo ranks."""
    made = {n: (a, *_case(a, kw), kw) for n, (a, kw) in cases.items()}
    path = str(tmp_dir / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(made, f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=600)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    ranks = run_ranks(split_step, 4, backend="gloo", device="cpu",
                      timeout=600, args=("2x2", made))
    return {"cases": made, "jax": jax_out, "ranks": ranks}


def _family(arch) -> str:
    from repro_torch.configs import get_config
    return get_config(arch, smoke=True).family


def check_against_jax(runs, name) -> None:
    arch, _, _, kw = runs["cases"][name]
    ranks = [r[name] for r in runs["ranks"]]
    want = unstacked(runs["jax"][name]["grads"])
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    tol = GRAD_TOL.get(_family(arch), GRAD_TOL["default"])
    for k, g in got.items():
        w = np.asarray(want[k])
        bound = tol * gmax
        if kw.get("grad_compression"):
            bound += COMPRESSION_ULP * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= bound, (name, k, err, bound)
    jm = runs["jax"][name]["metrics"]
    for r in ranks:
        assert set(r["metrics"]) == set(jm)
        for k, v in jm.items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(r["metrics"][k] - v) <= rtol * abs(v), (
                name, r["coords"], k, r["metrics"][k], v)


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


def check_shared_bits(runs, name) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.train import TrainConfig
    arch, np_state, _, kw = runs["cases"][name]
    ranks = [r[name] for r in runs["ranks"]]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], r["coords"]
        assert r["metrics"] == ranks[0]["metrics"], r["coords"]
    kw = dict(kw)
    over = {k: kw.pop(k) for k in ("remat",) if k in kw}
    kw.pop("steps", None)
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer"),
                                     **kw.pop("opt", {})), **kw)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **over)
    state = from_jax_train_state(np_state, cfg, tcfg, device="cpu")
    sh = layout.flat(layout.state_shardings(
        state, cfg, GridMesh(("data", "model"), (2, 2)), tcfg.opt.name))
    # every rank's gradient block is bitwise its block of the gathered
    # gradient
    whole = ranks[0]["grads"]
    split = 0
    for k, g in whole.items():
        s = sh[("params",) + tuple(k.split("."))]
        for r in ranks:
            blk = g[layout.block_slices(g.shape, s, r["coords"])]
            assert r["grad_blocks"][k] == _digest(blk), (k, r["coords"])
            split += blk.shape != g.shape
    assert split > 0
    # the ranks that hold one block of a leaf after the step hold the same
    # bits: each updated it from the same reduced gradient
    shared = 0
    for path, t in layout.flat(state).items():
        held = {}
        for r in ranks:
            where = str(layout.block_slices(t.shape, sh[path], r["coords"]))
            held.setdefault(where, set()).add(r["blocks"][".".join(path)])
        assert all(len(v) == 1 for v in held.values()), path
        shared += len(held) < len(ranks)
    assert shared > 0


def check_plan(runs, name) -> None:
    for r in (x[name] for x in runs["ranks"]):
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}, (name, plan)
        assert plan["gathered"] and all(
            k.startswith("params.") for k in plan["gathered"])
