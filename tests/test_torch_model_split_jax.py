"""The port's mesh step with the model split (`sharding.tensor`: tensor and
expert parallel on the "model" axis) on a 1x2 grid (model only) and a 2x2
grid of gloo ranks on the CPU, against the JAX package's jitted step on
a fake-device mesh of the same shape (``XLA_FLAGS=--xla_force_host_
platform_device_count=4``, in a subprocess: `_subproc.run_with_devices`),
laid out as the JAX launcher lays it out (``param_shardings`` in and out,
the batch by ``batch_spec``).  GSPMD computes the global program; each
port rank computes its share of the heads, mlp columns, experts and
vocab rows, and sums the partial products over its model line.

Two cases at the smoke configs, f32 activations, one step from the JAX
state carried across (`from_jax_train_state`), batch 4 x 16:

- gemma3-1b with the logdet aux (``logdet_reg`` 0.05, AdamW): 4 q heads
  split two ways while its one kv head stays whole (its k / v
  projections' gradients summed over the model line once), its mlp and
  vocab split;
- qwen2-moe-a2.7b (AdamW) at a batch where the capacity drops tokens
  (`tests/test_torch_split_jax.py` checks it drops): its experts and the
  shared experts' MLP split, ``qkv_bias``.

Held, on each grid: the reduced gradient before the clip (each rank's
blocks, gathered whole after the step) within GRAD_TOL of the largest
element of ``jax.grad`` of the JAX loss, the step's metrics within
METRIC_RTOL of the jitted step's, the gathered gradient bitwise the same
on every rank and every rank's gradient blocks bitwise its blocks of it,
the ranks that hold one block of a leaf after the step bitwise alike,
the step's collectives equal to `layout.step_plan`, and each rank of a
model line computing its own share of the heads (kv heads where they
divide), mlp columns, experts and vocab rows."""
from __future__ import annotations

import hashlib
import pickle

import numpy as np
import pytest

import torch

from repro_torch.core.mesh import run_ranks
from repro_torch.models.convert import unstacked

from _subproc import run_with_devices
from test_torch_ranks import split_step
from test_torch_split_jax import _case

GRAD_TOL = 1e-5
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
CASES = {"gemma3-1b": {"optimizer": "adamw", "logdet_reg": 0.05},
         "qwen2-moe-a2.7b": {"optimizer": "adamw"}}
# what each rank of a model line of two computes: (its share, the whole)
SHARES = {"gemma3-1b": {"heads": (2, 4), "kv_heads": (1, 1),
                        "mlp": (64, 128), "vocab": (128, 256)},
          "qwen2-moe-a2.7b": {"heads": (2, 4), "kv_heads": (2, 4),
                              "mlp": (16, 32), "experts": (4, 8),
                              "vocab": (128, 256)}}

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {arch: _case(arch, kw) for arch, kw in CASES.items()}
    path = str(tmp_path_factory.mktemp("model_split_jax") / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump(({a: (s, b, CASES[a]) for a, (s, b) in cases.items()},
                     GRIDS), f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=900)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    made = {a: (a, s, b, CASES[a]) for a, (s, b) in cases.items()}
    ranks = {grid: run_ranks(split_step, dims[0] * dims[1], backend="gloo",
                             device="cpu", timeout=600, args=(grid, made))
             for grid, dims in GRIDS.items()}
    return {"cases": cases, "jax": jax_out, "ranks": ranks}


PARAMS = [(g, a) for g in GRIDS for a in CASES]


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_model_split_step_is_the_jax_meshs_step(runs, grid, arch):
    ranks = [r[arch] for r in runs["ranks"][grid]]
    want = unstacked(runs["jax"][grid, arch]["grads"])
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, g in got.items():
        err = float(np.abs(g - np.asarray(want[k])).max())
        assert err <= GRAD_TOL * gmax, (grid, arch, k, err, gmax)
    jm = runs["jax"][grid, arch]["metrics"]
    for r in ranks:
        assert set(r["metrics"]) == set(jm)
        for k, v in jm.items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(r["metrics"][k] - v) <= rtol * abs(v), (
                grid, arch, r["coords"], k, r["metrics"][k], v)


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_every_rank_of_a_line_holds_the_same_bits(runs, grid, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.train import TrainConfig
    ranks = [r[arch] for r in runs["ranks"][grid]]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], r["coords"]
        assert r["metrics"] == ranks[0]["metrics"], r["coords"]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    kw = dict(CASES[arch])
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
    state = from_jax_train_state(runs["cases"][arch][0], cfg, tcfg,
                                 device="cpu")
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
    assert shared > 0


@pytest.mark.parametrize("grid,arch", PARAMS)
def test_collectives_equal_the_plan_and_each_rank_computes_its_share(
        runs, grid, arch):
    for r in (x[arch] for x in runs["ranks"][grid]):
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}, (grid, plan)
        assert plan["model_all_sum"] > 0
        m = r["coords"]["model"]
        want = {k: [(n, whole, None if n == whole else m * n)]
                for k, (n, whole) in SHARES[arch].items()}
        assert r["shares"] == want, (grid, r["coords"], r["shares"])
    if grid == "1x2":
        # one data rank: nothing is gathered but the leaves the model line
        # computes whole (the router), and only gemma3's whole k / v
        # projections' gradients are summed (over the model line)
        plan = runs["ranks"][grid][0][arch]["plan"]
        assert plan["broadcast"] == (8 if arch == "qwen2-moe-a2.7b" else 0)
        grads = 6 * 2 if arch == "gemma3-1b" else 0
        assert plan["all_sum"] == plan["model_all_sum"] + grads + 2
