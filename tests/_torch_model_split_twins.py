"""Shared by tests/test_torch_model_split_jax*.py: the port's split mesh
step on 1x2 and 2x2 grids of gloo ranks on the CPU (rank function
`test_torch_ranks.split_step`) against the JAX package's jitted step on
a fake-device mesh of the same shape (``XLA_FLAGS=--xla_force_host_
platform_device_count=4``, in a subprocess: `_subproc.run_with_devices`),
laid out as the JAX launcher lays it out (``param_shardings`` in and
out, the batch by ``batch_spec``).

`run` gives both sides' outputs for ``cases`` ({arch: TrainConfig
keywords}: the smoke config at f32 activations, one step from the JAX
state carried across, batch 4 x 16).  `check_grads`, `check_bits` and
`check_plan_and_shares` hold one case on one grid:

- the reduced gradient before the clip (each rank's blocks, gathered
  whole after the step) within ``tol`` of the largest element of
  ``jax.grad`` of the JAX loss, the metrics within METRIC_RTOL of the
  jitted step's;
- the gathered gradient bitwise the same on every rank, every rank's
  gradient blocks bitwise its blocks of it, the ranks that hold one
  block of a leaf after the step bitwise alike (-> how many leaves more
  than one rank holds);
- the step's collectives equal to `layout.step_plan`, and each rank of a
  model line computing its own share of what ``shares`` names
  ({kind: (the rank's share, the whole)})."""
from __future__ import annotations

import hashlib
import pickle

import numpy as np
import torch

from repro_torch.core.mesh import run_ranks
from repro_torch.models.convert import unstacked

from _subproc import run_with_devices
from test_torch_ranks import split_step
from test_torch_split_jax import _case

GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}

JAX_CODE = """
import pickle
import numpy as np
jax.config.update("jax_enable_x64", False)
from jax.sharding import Mesh, NamedSharding
from repro.configs.registry import get_config
from repro.optim.optimizers import OptConfig
from repro.sharding import hints
from repro.sharding.rules import batch_spec, param_shardings
from repro.train.step import TrainConfig, make_loss_fn, make_train_step

with open({path!r}, "rb") as f:
    cases, grids = pickle.load(f)
out = {{}}
for grid, dims in grids.items():
    mesh = Mesh(np.asarray(jax.devices()[:dims[0] * dims[1]]).reshape(dims),
                ("data", "model"))
    for arch, (state, batch, kw) in cases.items():
        kw = dict(kw)
        tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
        cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
        hints.configure(cfg, mesh)
        sh = {{"params": param_shardings(state["params"], cfg, mesh),
               "opt": param_shardings(state["opt"], cfg, mesh),
               "step": NamedSharding(mesh, jax.sharding.PartitionSpec())}}
        bsh = {{k: NamedSharding(mesh, s) for k, s in batch_spec(
            cfg, mesh, kind="train",
            batch=batch["tokens"].shape[0]).items()}}
        with mesh:
            st = jax.device_put(state, sh)
            b = jax.device_put(batch, bsh)
            loss = make_loss_fn(cfg, tcfg)
            grads = jax.jit(jax.grad(lambda p, x: loss(p, x)[0]),
                            in_shardings=(sh["params"], bsh))(
                                st["params"], b)
            _, metrics = jax.jit(make_train_step(cfg, tcfg),
                                 in_shardings=(sh, None),
                                 out_shardings=(sh, None))(st, b)
        out[grid, arch] = {{"grads": jax.device_get(grads), "metrics": {{
            k: float(v) for k, v in metrics.items()}}}}
        hints.configure(cfg, None)
with open({path!r} + ".out", "wb") as f:
    pickle.dump(out, f)
"""


def run(tmp_path, cases: dict) -> dict:
    """JAX's gradients and metrics and the port's ranks' outputs, by grid,
    for ``cases`` ({arch: TrainConfig keywords with ``optimizer``})."""
    made = {a: (a,) + _case(a, kw) + (kw,) for a, kw in cases.items()}
    path = str(tmp_path / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(({a: (s, b, kw) for a, (_, s, b, kw) in made.items()},
                     GRIDS), f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=900)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    ranks = {grid: run_ranks(split_step, dims[0] * dims[1], backend="gloo",
                             device="cpu", timeout=600, args=(grid, made))
             for grid, dims in GRIDS.items()}
    return {"made": made, "jax": jax_out, "ranks": ranks}


def grad_err(runs, grid: str, name: str) -> tuple:
    """(the largest difference of rank 0's gathered gradient from JAX's,
    JAX's largest element)."""
    want = unstacked(runs["jax"][grid, name]["grads"])
    got = runs["ranks"][grid][0][name]["grads"]
    assert set(got) == set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(g - np.asarray(want[k])).max())
               for k, g in got.items()), gmax


def check_grads(runs, grid: str, name: str, tol: float) -> None:
    err, gmax = grad_err(runs, grid, name)
    assert err <= tol * gmax, (grid, name, err, gmax)
    jm = runs["jax"][grid, name]["metrics"]
    for r in (x[name] for x in runs["ranks"][grid]):
        assert set(r["metrics"]) == set(jm)
        for k, v in jm.items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(r["metrics"][k] - v) <= rtol * abs(v), (
                grid, name, r["coords"], k, r["metrics"][k], v)


def check_bits(runs, grid: str, name: str) -> int:
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.train import TrainConfig
    arch, np_state, _, kw = runs["made"][name]
    ranks = [r[name] for r in runs["ranks"][grid]]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], r["coords"]
        assert r["metrics"] == ranks[0]["metrics"], r["coords"]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    kw = dict(kw)
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
    state = from_jax_train_state(np_state, cfg, tcfg, device="cpu")
    sh = layout.flat(layout.state_shardings(
        state, cfg, GridMesh(("data", "model"), GRIDS[grid]), tcfg.opt.name))
    split = 0
    for k, g in ranks[0]["grads"].items():
        s = sh[("params",) + tuple(k.split("."))]
        for r in ranks:
            blk = np.ascontiguousarray(
                g[layout.block_slices(g.shape, s, r["coords"])])
            assert r["grad_blocks"][k] == hashlib.sha256(
                blk.data).hexdigest(), (k, r["coords"])
            split += blk.shape != g.shape
    assert split > 0
    shared = 0
    for path, t in layout.flat(state).items():
        held = {}
        for r in ranks:
            where = str(layout.block_slices(t.shape, sh[path], r["coords"]))
            held.setdefault(where, set()).add(r["blocks"][".".join(path)])
        assert all(len(v) == 1 for v in held.values()), path
        shared += len(held) < len(ranks)
    return shared


def check_plan_and_shares(runs, grid: str, name: str, shares: dict) -> dict:
    """-> rank 0's `layout.step_plan`."""
    for r in (x[name] for x in runs["ranks"][grid]):
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}, (grid, plan)
        assert plan["model_all_sum"] > 0
        m = r["coords"]["model"]
        want = {k: [(n, whole, None if n == whole else m * n)]
                for k, (n, whole) in shares.items()}
        assert r["shares"] == want, (grid, r["coords"], r["shares"])
    return runs["ranks"][grid][0][name]["plan"]
