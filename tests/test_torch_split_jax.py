"""The port's split mesh step (`sharding.layout.mesh_step`) on a 2x2 grid
of gloo ranks on the CPU against the JAX package's jitted step on a
fake-device 2x2 mesh (``XLA_FLAGS=--xla_force_host_platform_device_count
=4``, in a subprocess: `_subproc.run_with_devices`), laid out as the JAX
launcher lays it out (`repro.launch.train.build`: ``param_shardings`` in
and out, the batch by ``batch_spec``).  GSPMD computes the global
program; the port's ranks each take their share of the batch and reduce
the statistics of the whole batch over the data axis, and compute their
share of the heads, mlp columns, experts and vocab rows on the model
axis (`sharding.tensor`; tests/test_torch_model_split_jax.py holds a
1x2 grid too).

Two cases at the smoke configs, f32 activations, one step from the JAX
state carried across (`from_jax_train_state`), batch 4 x 16:

- gemma3-1b with the logdet aux (``logdet_reg`` 0.05, AdamW): the aux's
  covariance is over all four rows, two on each data rank;
- qwen2-moe-a2.7b (AdamW) at a batch where the capacity drops tokens
  (checked here): the capacity, the slots and the balance aux are the
  global batch's.

Held: the reduced gradient before the clip (each rank's blocks, gathered
whole after the step) within GRAD_TOL of the largest element of
``jax.grad`` of the JAX loss (the phase-14 gate), the step's metrics
within METRIC_RTOL of the jitted step's, the gathered gradient bitwise
the same on every rank and every rank's gradient blocks bitwise its
blocks of it (so the ranks that hold one block hold the same bits), the
ranks that hold one block of a leaf after the step bitwise alike, and
the step's collectives equal to `layout.step_plan`, which gathers no
optimizer leaf.  A per-rank capacity, a per-rank covariance or a sum in
the backward of the ranks' reductions each fails these gates (shown by
mutation).  The parameters are gathered one unit at a time
(`sharding.fsdp`; tests/test_torch_layer_gather*.py hold its other
cases)."""
from __future__ import annotations

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import get_optimizer as jax_optimizer
from repro.train.step import TrainConfig as JTrainConfig

from repro_torch.core.mesh import run_ranks
from repro_torch.models.convert import from_jax_params, unstacked
from repro_torch.models.moe import MoE, capacity

from _subproc import run_with_devices
from _torch_train_twins import jax_params
from test_torch_ranks import split_step

GRAD_TOL = 1e-5
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
BATCH, SEQ = 4, 16
CASES = {"gemma3-1b": {"optimizer": "adamw", "logdet_reg": 0.05},
         "qwen2-moe-a2.7b": {"optimizer": "adamw"}}

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
for arch, (state, batch, kw) in cases.items():
    kw = dict(kw)
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
    cfg = get_config(arch, smoke=True).replace(dtype=jnp.float32)
    hints.configure(cfg, mesh)
    sh = {{"params": param_shardings(state["params"], cfg, mesh),
           "opt": param_shardings(state["opt"], cfg, mesh),
           "step": NamedSharding(mesh, jax.sharding.PartitionSpec())}}
    bsh = {{k: NamedSharding(mesh, s) for k, s in batch_spec(
        cfg, mesh, kind="train", batch=batch["tokens"].shape[0]).items()}}
    with mesh:
        st = jax.device_put(state, sh)
        b = jax.device_put(batch, bsh)
        loss = make_loss_fn(cfg, tcfg)
        grads = jax.jit(jax.grad(lambda p, x: loss(p, x)[0]),
                        in_shardings=(sh["params"], bsh))(st["params"], b)
        _, metrics = jax.jit(make_train_step(cfg, tcfg),
                             in_shardings=(sh, None),
                             out_shardings=(sh, None))(st, b)
    out[arch] = {{"grads": jax.device_get(grads),
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}}
    hints.configure(cfg, None)
with open({path!r} + ".out", "wb") as f:
    pickle.dump(out, f)
"""


def _case(arch, kw, batch=BATCH):
    """(the JAX train state's numpy tree, a seeded numpy batch)."""
    jcfg, _, params = jax_params(arch)
    jt = JTrainConfig(opt=JOptConfig(name=kw["optimizer"]),
                      **{k: v for k, v in kw.items() if k != "optimizer"})
    state = jax.device_get({"params": params,
                            "opt": jax_optimizer(jt.opt)[0](params),
                            "step": jnp.zeros((), jnp.int32)})
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab, (batch, SEQ)).astype(np.int32)
    return state, {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _dropped(arch, state, batch) -> int:
    """Assignments past the capacity in the port's one-device forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    model = from_jax_params(state["params"], cfg, device="cpu")
    drops = []
    real = MoE.forward

    def count(self, x):
        n = x.shape[0] * x.shape[1]
        _, _, topi = self.route(x.reshape(n, -1))
        per = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
        drops.append(int((per - capacity(cfg, n)).clamp(min=0).sum()))
        return real(self, x)
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(MoE, "forward", count)
        forward(model, {"tokens": torch.from_numpy(batch["tokens"])})
    return sum(drops)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {arch: _case(arch, kw) for arch, kw in CASES.items()}
    path = str(tmp_path_factory.mktemp("split_jax") / "cases.pkl")
    with open(path, "wb") as f:
        pickle.dump({a: (s, b, CASES[a]) for a, (s, b) in cases.items()}, f)
    run_with_devices(JAX_CODE.format(path=path), 4, timeout=600)
    with open(path + ".out", "rb") as f:
        jax_out = pickle.load(f)
    ranks = run_ranks(split_step, 4, backend="gloo", device="cpu",
                      timeout=600, args=("2x2", {
                          a: (a, s, b, CASES[a]) for a, (s, b) in
                          cases.items()}))
    return {"cases": cases, "jax": jax_out, "ranks": ranks}


def test_the_moe_case_drops_tokens(runs):
    state, batch = runs["cases"]["qwen2-moe-a2.7b"]
    assert _dropped("qwen2-moe-a2.7b", state, batch) > 0


@pytest.mark.parametrize("arch", list(CASES))
def test_split_step_is_the_jax_meshs_step(runs, arch):
    ranks = [r[arch] for r in runs["ranks"]]
    want = unstacked(runs["jax"][arch]["grads"])
    got = ranks[0]["grads"]
    assert set(got) == set(want)
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, g in got.items():
        err = float(np.abs(g - np.asarray(want[k])).max())
        assert err <= GRAD_TOL * gmax, (arch, k, err, gmax)
    jm = runs["jax"][arch]["metrics"]
    for r in ranks:
        assert set(r["metrics"]) == set(jm)
        for k, v in jm.items():
            rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
            assert abs(r["metrics"][k] - v) <= rtol * abs(v), (
                arch, r["coords"], k, r["metrics"][k], v)


@pytest.mark.parametrize("arch", list(CASES))
def test_every_rank_reduces_the_same_bits(runs, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.optim import OptConfig
    from repro_torch.sharding import layout
    from repro_torch.train import TrainConfig
    import hashlib
    ranks = [r[arch] for r in runs["ranks"]]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], r["coords"]
        assert r["metrics"] == ranks[0]["metrics"], r["coords"]
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    kw = dict(CASES[arch])
    tcfg = TrainConfig(opt=OptConfig(name=kw.pop("optimizer")), **kw)
    state = from_jax_train_state(runs["cases"][arch][0], cfg, tcfg,
                                 device="cpu")
    sh = layout.flat(layout.state_shardings(
        state, cfg, GridMesh(("data", "model"), (2, 2)), tcfg.opt.name))
    # each rank keeps its blocks of the reduced gradient: bitwise its
    # blocks of the gathered gradient, so the ranks that hold one block
    # hold the same bits
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


@pytest.mark.parametrize("arch", list(CASES))
def test_split_step_collectives_equal_the_plan(runs, arch):
    for r in (x[arch] for x in runs["ranks"]):
        plan = r["plan"]
        assert r["counts"] == {"broadcast": plan["broadcast"],
                               "all_sum": plan["all_sum"]}, (arch, plan)
        assert plan["gathered"] and all(
            k.startswith("params.") for k in plan["gathered"])
    # the nll; the MoE layers exchange twice a forward, and remat runs
    # each again; the aux's two; one all_sum of every gradient; the global
    # norm's; the agreement; and the model line's: a split attention's
    # output (its forward and its recomputation) and its input's gradient,
    # a split MLP's the same (gemma3: 6 layers), a MoE layer with split
    # experts its output twice, its input's and combine weights' gradients
    # (qwen2-moe: 2 layers), the vocab-parallel lookups (with the aux, its
    # own too) and the one CE chunk's exchange twice and its gradient
    plan = runs["ranks"][0][arch]["plan"]
    moe = 2 if arch == "qwen2-moe-a2.7b" else 0
    aux = 2 if CASES[arch].get("logdet_reg") else 0
    grads = len(runs["ranks"][0][arch]["digests"])
    model = {"gemma3-1b": 6 * (3 + 3) + 2 + 3,
             "qwen2-moe-a2.7b": 2 * (3 + 4) + 1 + 3}[arch]
    assert plan["model_all_sum"] == model
    assert plan["all_sum"] == 1 + aux + moe * 2 * 2 + grads + 1 + 1 + model
