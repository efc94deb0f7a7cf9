"""CPU twins of `repro_torch.launch.train` against `repro.launch.train`.

`build` on one CPU rank (a 1x1 grid), its state replaced by a JAX
``init_train_state`` carried across (`from_jax_train_state`, laid out by
`sharding.layout.shard`), takes three steps on the JAX ``batch_fn``'s
numpy batches; before each, the port's state is carried back into the
JAX layout and JAX's own ``build`` step (jitted, on a 1x1 mesh) takes
the same step from it.  Held per step, within the train twins' gates:
the metrics (METRIC_RTOL), and the clipped gradient the port's step applied
(captured from the mesh step's clip) against the JAX clip of ``jax.grad`` of the JAX
loss at that state, within GRAD_TOL of the largest element (1e-4 for
the SSM and hybrid families, whose chunked scans sum in another order).
Both packages' configs are patched to f32 activations.  Also `main` on
the CPU, end to end: its log lines, checkpoints and final step."""
from __future__ import annotations

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch import train as JT
from repro.launch.mesh import make_mesh_like as jax_mesh_like
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import clip_by_global_norm as jax_clip
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_loss_fn as jax_loss_fn

from repro_torch.configs import get_config
from repro_torch.launch import train as T
from repro_torch.launch.mesh import make_mesh_like
from repro_torch.models.convert import from_jax_train_state, unstacked
from repro_torch.optim import OptConfig, jax_leaves
from repro_torch.sharding import layout
from repro_torch.train import TrainConfig

METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
GRAD_TOL = {"ssm": 1e-4, "hybrid": 1e-4, "default": 1e-5}
STEPS, BATCH, SEQ = 3, 4, 16
CASES = {"qwen2.5-3b": 0.05, "mamba2-370m": 0.0}   # arch -> logdet_reg


def to_jax_state(state) -> dict:
    """The port's (whole) train state in the JAX tree's layout."""
    named = dict(state["params"].named_parameters())
    params = {}
    for leaf in jax_leaves(named):
        ts = [named[n].detach().numpy() for n in leaf.names]
        arr = (np.stack(ts).reshape(tuple(leaf.lead) + ts[0].shape)
               if leaf.lead else ts[0])
        node = params
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = arr

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return np.array(t.numpy())
    return jax.tree.map(jnp.asarray, {
        "params": params, "opt": tree(state["opt"]),
        "step": np.asarray(int(state["step"]), np.int32)})


def _f32(monkeypatch):
    monkeypatch.setattr(JT, "get_config", lambda a, smoke=False: jax_config(
        a, smoke=smoke).replace(dtype=jnp.float32))
    monkeypatch.setattr(T, "get_config", lambda a, smoke=False: get_config(
        a, smoke=smoke).replace(dtype=torch.float32))


@pytest.mark.parametrize("arch", list(CASES))
def test_build_steps_match_the_jax_launcher(arch, monkeypatch):
    _f32(monkeypatch)
    reg = CASES[arch]
    jt = JTrainConfig(opt=JOptConfig(name="adamw", lr=3e-3,
                                     decay_steps=STEPS), logdet_reg=reg)
    tt = TrainConfig(opt=OptConfig(name="adamw", lr=3e-3,
                                   decay_steps=STEPS), logdet_reg=reg)
    jcfg, jstate, jstep, jbatch_fn, _ = JT.build(
        arch, smoke=True, mesh=jax_mesh_like("1x1"), tcfg=jt, batch=BATCH,
        seq=SEQ)
    grid = make_mesh_like("1x1", device="cpu")
    cfg, _, step_fn, _, sh = T.build(arch, smoke=True, mesh=grid, tcfg=tt,
                                     batch=BATCH, seq=SEQ)
    assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
    state = layout.shard(from_jax_train_state(jax.device_get(jstate), cfg,
                                              tt, device="cpu"), sh)
    del jstate
    jloss = jax.jit(jax.grad(lambda p, b: jax_loss_fn(jcfg, jt)(p, b)[0]))
    seen, real_clip = [], layout.clip_by_global_norm

    def clip(grads, max_norm, norm=None):
        out = real_clip(grads, max_norm, norm=norm)
        seen.append(out[0])
        return out
    tol = GRAD_TOL.get(cfg.family, GRAD_TOL["default"])
    for k in range(STEPS):
        batch = jax.device_get(jbatch_fn(k))
        jb = {n: jnp.asarray(v) for n, v in batch.items()}
        js = to_jax_state(state)
        jg, _ = jax_clip(jloss(js["params"], jb), jt.opt.clip_norm)
        _, jm = jstep(js, jb)
        with monkeypatch.context() as mp:
            mp.setattr(layout, "clip_by_global_norm", clip)
            state, m = step_fn(state, {n: torch.from_numpy(np.array(v))
                                       for n, v in batch.items()})
        got = seen.pop()
        want = unstacked(jax.device_get(jg))
        assert set(got) == set(want)
        gmax = max(float(np.abs(v).max()) for v in want.values())
        for n, g in got.items():
            err = float(np.abs(g.detach().numpy() - want[n]).max())
            assert err <= tol * gmax, (arch, k, n, err, gmax)
        jm = {n: float(v) for n, v in jax.device_get(jm).items()}
        assert set(m) == set(jm)
        for n, want_v in jm.items():
            rtol = METRIC_RTOL.get(n, METRIC_RTOL["default"])
            assert abs(float(m[n]) - want_v) <= rtol * abs(want_v), (
                arch, k, n, float(m[n]), want_v)
    assert int(state["step"]) == STEPS


def test_main_on_the_cpu(tmp_path, capsys):
    state = T.main(["--arch", "qwen2.5-3b", "--steps", "4", "--batch", "4",
                    "--seq", "16", "--log-every", "2", "--ckpt-every", "2",
                    "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert int(state["step"]) == 4
    assert re.search(r"^step     2  loss \d+\.\d{4}  nll \d+\.\d{4}  "
                     r"gnorm \d+\.\d{3}$", out, re.M), out
    assert re.search(r"^4 steps in [\d.]+s \(\d+ ms/step median-ish\); "
                     r"restarts=0 stragglers=\[.*\]$", out, re.M), out
    assert re.search(r"^loss: first=\d+\.\d{4} last=\d+\.\d{4}$", out,
                     re.M), out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000004"]
    assert next(state["params"].parameters()).device.type == "cpu"


def test_main_refuses_a_mesh_without_enough_ranks():
    with pytest.raises(ValueError):
        T._mesh("2x2x", "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh_like("2x2", device="cpu")
