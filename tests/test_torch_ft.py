"""CPU twins of `repro_torch.ft.driver` against `repro.ft.driver`
(tests/test_substrates.py's driver tests: restart resumes, max restarts,
straggler), plus what the port must add because its step updates in
place: a run restarted from a checkpoint, or from the state it holds
before any checkpoint, ends bitwise equal to an uninterrupted one."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synth_batch
from repro_torch.ft.driver import FTConfig, run_training
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def tiny_cfg():
    return get_config("qwen2.5-3b", smoke=True).replace(
        dtype=torch.float32, n_layers=1, d_model=32, d_ff=64, vocab=64,
        n_heads=2, n_kv_heads=2, head_dim=16)


def setup(tcfg):
    cfg = tiny_cfg()
    state = init_train_state(cfg, tcfg, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    data = DataConfig(seed=0, batch=2, seq=8)
    return (state, make_train_step(cfg, tcfg),
            lambda s: synth_batch(cfg, data, s, device="cpu"))


def _flat(state):
    out = {f"params.{k}": p.detach()
           for k, p in state["params"].named_parameters()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v
    walk(state["opt"], "opt.")
    out["step"] = state["step"]
    return out


def assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(
            fa[k].reshape(-1).view(torch.uint8),
            fb[k].reshape(-1).view(torch.uint8)), k


def test_ft_restart_resumes(tmp_path):
    tcfg = TrainConfig(opt=OptConfig(name="sgd", lr=1e-3, warmup=1,
                                     decay_steps=50))
    state, step_fn, batch_fn = setup(tcfg)
    boom = {"armed": True}

    def injector(step):
        if step == 12 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=5, async_ckpt=False,
                  max_restarts=2)
    state, stats = run_training(state=state, train_step=step_fn,
                                batch_fn=batch_fn, n_steps=20, ft=ft,
                                fault_injector=injector)
    assert stats.restarts == 1
    assert int(state["step"]) == 20
    assert ckpt.latest_step(tmp_path) == 20


def test_ft_max_restarts(tmp_path):
    def always_fail(step):
        raise RuntimeError("dead node")

    def step_fn(s, b):
        raise RuntimeError()
    with pytest.raises(RuntimeError, match="max_restarts"):
        run_training(state={"step": torch.tensor(0)}, train_step=step_fn,
                     batch_fn=lambda s: None, n_steps=3,
                     ft=FTConfig(ckpt_dir=str(tmp_path), max_restarts=1),
                     fault_injector=always_fail)


def test_straggler_detection(tmp_path):
    tcfg = TrainConfig(opt=OptConfig(name="sgd"))
    state, step_fn, batch_fn = setup(tcfg)

    def slow_injector(step):
        if step == 15:
            time.sleep(1.0)           # simulated straggler

    ft = FTConfig(ckpt_dir=str(tmp_path), ckpt_every=100, async_ckpt=False,
                  straggler_factor=3.0)
    _, stats = run_training(state=state, train_step=step_fn,
                            batch_fn=batch_fn, n_steps=20, ft=ft,
                            fault_injector=slow_injector)
    assert 15 in stats.stragglers
    assert len(stats.times) == 20


@pytest.mark.parametrize("fault_at,ckpt_every", [(12, 5), (3, 100)])
def test_restarted_run_equals_uninterrupted_bitwise(tmp_path, fault_at,
                                                    ckpt_every):
    """20 adamw steps with the logdet aux: once straight through, once
    with a node failure at ``fault_at`` (async checkpoints every
    ``ckpt_every`` steps: restored from step 10, or, with none saved yet,
    on from the state held).  The two final states are bitwise equal,
    and ``on_metrics`` saw the same floats at every step."""
    tcfg = TrainConfig(opt=OptConfig(name="adamw", lr=1e-2, warmup=2,
                                     decay_steps=20), logdet_reg=0.05)
    seen = {"straight": {}, "restarted": {}}

    def record(run):
        def on_metrics(step, m):
            assert all(isinstance(v, float) for v in m.values())
            seen[run][step] = m
        return on_metrics

    state, step_fn, batch_fn = setup(tcfg)
    straight, stats = run_training(
        state=state, train_step=step_fn, batch_fn=batch_fn, n_steps=20,
        ft=FTConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=ckpt_every),
        on_metrics=record("straight"))
    assert stats.restarts == 0

    boom = {"armed": True}

    def injector(step):
        if step == fault_at and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    state, step_fn, batch_fn = setup(tcfg)
    restarted, stats = run_training(
        state=state, train_step=step_fn, batch_fn=batch_fn, n_steps=20,
        ft=FTConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=ckpt_every),
        on_metrics=record("restarted"), fault_injector=injector)
    assert stats.restarts == 1
    assert int(restarted["step"]) == 20
    assert_bitwise(restarted, straight)
    assert seen["restarted"][20] == seen["straight"][20]
    assert set(seen["straight"][20]) == {"nll", "logdet_reg", "loss",
                                         "grad_norm"}
    assert np.isfinite(list(seen["straight"][20].values())).all()
