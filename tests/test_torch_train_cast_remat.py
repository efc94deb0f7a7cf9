"""``TrainConfig.cast_params_bf16`` on one device under ``cfg.remat``.

The forward runs on bf16 casts of the f32 leaves of JAX rank >= 2, and
JAX casts inside the rematerialised function, so a block's recomputation
in the backward reads the same bf16 weights as its forward.  The port
casts per unit as each unit is called (a one-rank `sharding.fsdp`
scope, the mesh step's own mechanism), so its checkpoint's
recomputation casts again: one step with remat is bitwise the step
without (gemma3-1b smoke, f32 activations, sgd and adamw, one step from
one seed).  A forward on casts made once outside the recomputed region
(the earlier ``torch.func.functional_call`` path) recomputes each block
on the f32 weights and fails this by 7e-3 of the largest gradient
element here.

The one-device cast step is also held against a 2x1 grid's
(`sharding.layout.mesh_step`, gloo ranks on the CPU, the cast before each
block's gather): the gradient of a bf16 copy is rounded to bf16 at the
cast, once on one device and once per rank's partial sum on the grid,
so each reduced gradient lies within CAST_ULP (one bf16 ulp, 2^-7) of
its leaf's largest element, the metrics within METRIC_RTOL, and the
gradient's norm within the norm of the two gradients' difference (the
triangle inequality) plus METRIC_RTOL."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mesh import run_ranks
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, init_train_state, make_grad_fn, \
    make_train_step

from test_torch_ranks import split_step

ARCH = "gemma3-1b"
BATCH, SEQ = 4, 16
CAST_ULP = 2.0 ** -7
METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}


def _batch():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, get_config(ARCH, smoke=True).vocab,
                       (BATCH, SEQ)).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def _step(optimizer: str, remat: bool):
    """One cast step from seed 0: (its gradients, the state after it,
    its metrics)."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32,
                                               remat=remat)
    tcfg = TrainConfig(opt=OptConfig(name=optimizer), cast_params_bf16=True)
    state = init_train_state(cfg, tcfg, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads, _ = make_grad_fn(cfg, tcfg)(state["params"], batch)
    state, metrics = make_train_step(cfg, tcfg)(state, batch)
    after = {n: p.detach().clone()
             for n, p in state["params"].named_parameters()}
    return grads, after, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_cast_step_under_remat_is_bitwise_the_step_without(optimizer):
    g1, p1, m1 = _step(optimizer, remat=True)
    g0, p0, m0 = _step(optimizer, remat=False)
    assert set(g1) == set(g0) == set(p1)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), (k, float(
            (g1[k] - g0[k]).abs().max()))
        assert torch.equal(p1[k], p0[k]), k
    assert m1 == m0


def test_cast_step_without_remat_casts_its_blocks():
    """The cast is in force in both steps above: the gradient differs
    from the uncast step's."""
    cfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads = []
    for cast in (False, True):
        tcfg = TrainConfig(opt=OptConfig(name="sgd"), cast_params_bf16=cast)
        state = init_train_state(cfg, tcfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
        grads.append(make_grad_fn(cfg, tcfg)(state["params"], batch)[0])
    assert any(not torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


def test_one_device_cast_step_is_the_2x1_grids():
    cases = {ARCH: (ARCH, 0, _batch(), {"optimizer": "adamw",
                                        "cast_params_bf16": True})}
    threads = torch.get_num_threads()
    try:
        one = split_step(None, "1x1", cases)[ARCH]
    finally:
        torch.set_num_threads(threads)
    grid = run_ranks(split_step, 2, backend="gloo", device="cpu",
                     timeout=600, args=("2x1", cases))
    got = grid[0][ARCH]
    assert set(got["grads"]) == set(one["grads"])
    diff = 0.0
    for k, want in one["grads"].items():
        d = got["grads"][k].astype(np.float64) - want
        err = float(np.abs(d).max())
        assert err <= CAST_ULP * float(np.abs(want).max()), (k, err)
        diff += float(np.sum(d * d))
    for r in grid:
        assert r[ARCH]["digests"] == got["digests"]
        for k, v in one["metrics"].items():
            got_k = r[ARCH]["metrics"][k]
            if k == "grad_norm":
                # the norms of two gradients differ by at most the norm of
                # their difference (held above), plus the norm's rounding
                bound = np.sqrt(diff) + METRIC_RTOL[k] * abs(v)
            else:
                bound = METRIC_RTOL["default"] * abs(v)
            assert abs(got_k - v) <= bound, (k, got_k, v)
    assert one["counts"] == {"broadcast": 0, "all_sum": 0}
