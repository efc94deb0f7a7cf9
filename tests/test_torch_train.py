"""CPU twins of `repro_torch.train` against `repro.train`: the losses,
the logdet aux through the exact VJP, one train step of qwen2.5-3b at
its smoke config with sgd and the logdet aux (the twin of
tests/test_launch_integration.py::test_logdet_reg_training_uses_core;
the checks of `tests/_torch_train_twins.py`), and the step's commit
point.  The other steps' twins are split so that each file takes one
worker of the parallel run for well under a minute:
test_torch_train_qwen.py (adamw, adafactor), test_torch_train_moe.py and
test_torch_train_depth2.py (sgd, adamw), test_torch_train_adafactor.py
(the MoE and depth-2 archs), test_torch_train_cast.py
(``cast_params_bf16``).  Every input is seeded numpy."""
from __future__ import annotations

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.train import loss as JL

from repro_torch.analysis.ir import record
from repro_torch.configs import get_config
from repro_torch.optim import OptConfig
from repro_torch.train import (TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train import loss as TL
from repro_torch.train import step as TS

from _torch_train_twins import check_case, run_case

# f32 losses: the same terms in another summation order
LOSS_RTOL = 1e-6
# gradients relative to the largest element of the same tensor
GRAD_REL_TO_MAX = 1e-5
# the aux's f32 gradient is inv(Cov + eps I)^T: an f32 inverse is off the
# exact one by about sqrt(d) cond(Cov + eps I) 2^-24 relative to its
# largest element (15 samples in d = 24: cond 5.2e3); each package within
# that of the f64 gradient, the two within twice it
LOGDET_RTOL = 1e-5


def rel_to_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def ce_inputs(b=2, t=24, d=16, v=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            (0.3 * rng.standard_normal((v, d))).astype(np.float32),
            rng.integers(0, v, (b, t)).astype(np.int32))


def test_cross_entropy_matches_jax():
    h, table, y = ce_inputs()
    logits = np.einsum("btd,vd->btv", h, table)
    for z in (0.0, 1e-4):
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                z_loss=z)
        got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                               z_loss=z)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)


@pytest.mark.parametrize("chunk,softcap,z", [(5, 0.0, 1e-4), (8, 30.0, 1e-4),
                                             (24, 0.0, 0.0), (7, 5.0, 1e-3)])
def test_chunked_cross_entropy_and_grads_match_jax(chunk, softcap, z):
    """Value and gradients (hidden and table) of the chunked CE, with a
    remainder chunk (24 % 5, % 7), softcap and z-loss, against JAX."""
    h, table, y = ce_inputs()

    def jf(hh, tt):
        return JL.chunked_cross_entropy(hh, tt, jnp.asarray(y),
                                        softcap=softcap, z_loss=z,
                                        chunk=chunk)
    want, (gh, gt) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    got = TL.chunked_cross_entropy(th, tt, torch.from_numpy(y),
                                   softcap=softcap, z_loss=z, chunk=chunk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert rel_to_max(th.grad, gh) <= GRAD_REL_TO_MAX
    assert rel_to_max(tt.grad, gt) <= GRAD_REL_TO_MAX
    # and equal to the dense CE of the port
    dense = TL.cross_entropy(
        torch.tanh(torch.einsum("btd,vd->btv", th, tt) / softcap) * softcap
        if softcap else torch.einsum("btd,vd->btv", th, tt),
        torch.from_numpy(y), z_loss=z)
    assert float(got.detach()) == pytest.approx(float(dense.detach()),
                                                rel=LOSS_RTOL)


def test_chunked_cross_entropy_keeps_no_logits_for_the_backward():
    """Each chunk runs under torch.utils.checkpoint: no (B, chunk, V)
    tensor is saved for the backward outside the checkpoints (an
    unchecked chunk saves its logits), and the gradient is still there."""
    h, table, y = ce_inputs(t=16)
    b, t, v = 2, 16, table.shape[0]
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = TL.chunked_cross_entropy(th, tt, torch.from_numpy(y), chunk=4)
    assert not [s for s in saved if len(s) == 3 and s[-1] == v], saved
    loss.backward()
    assert th.grad is not None and tt.grad is not None
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        TL._chunk_loss(th[:, :4], torch.from_numpy(y)[:, :4], tt, 0.0, 1e-4)
    assert (b, 4, v) in saved


def logdet_input(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3, 5, 24)).astype(np.float32)


def test_logdet_decorrelation_value_and_grad_match_jax():
    """Value and jax.grad on the same h, f32 in both packages (the JAX
    package differentiates through the condensation, the port takes the
    exact VJP: g * inv(A)^T either way), and both against the f64
    gradient of the same function."""
    h = logdet_input()
    want, gw = jax.value_and_grad(JL.logdet_decorrelation)(jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    got = TL.logdet_decorrelation(th)
    got.backward()
    assert got.dtype == torch.float32
    assert float(got.detach()) == pytest.approx(float(want), rel=LOGDET_RTOL)
    h64 = torch.from_numpy(h.astype(np.float64)).requires_grad_()
    flat = h64.reshape(-1, h.shape[-1])
    xc = flat - flat.mean(0)
    cov = xc.T @ xc / flat.shape[0] + 1e-3 * torch.eye(h.shape[-1],
                                                        dtype=torch.float64)
    d = h.shape[-1]
    (torch.trace(cov) / d - torch.logdet(cov) / d).backward()
    ku = d ** 0.5 * float(torch.linalg.cond(cov.detach())) * 2.0 ** -24
    assert rel_to_max(th.grad, h64.grad) <= ku
    assert rel_to_max(gw, h64.grad) <= ku
    assert rel_to_max(th.grad, gw) <= 2 * ku


def test_logdet_decorrelation_records_condensation_then_one_inverse():
    """The forward runs the rank-1 condensation (d - 1 K1 entries, the
    plain version here); the recorded backward is one linalg_inv_ex and
    no condensation step (no kernel entry, no argmax)."""
    h = torch.from_numpy(logdet_input()).requires_grad_()
    d = h.shape[-1]
    out = {}
    fwd = record(lambda: out.setdefault("v", TL.logdet_decorrelation(h)))
    k1 = [i for i in fwd.instructions if i.opcode == "kernel.rank1_update"]
    assert len(k1) == d - 1
    bwd = record(lambda: torch.autograd.grad(out["v"], h))
    ops = [i.opcode for i in bwd.instructions]
    assert ops.count("aten.linalg_inv_ex") == 1, ops
    assert not [o for o in ops if o.startswith("kernel.") or "argmax" in o]


def test_logdet_reg_train_step_matches_jax():
    """One SGD step of qwen2.5-3b at its smoke config with logdet_reg =
    0.05: the metrics (logdet_reg among them, finite), the deltas and the
    step against JAX's jitted step."""
    r = run_case("qwen2.5-3b", "sgd")
    assert np.isfinite(r["metrics"]["logdet_reg"])
    check_case(r)


def _snapshot(state):
    return copy.deepcopy({"params": dict(state["params"].named_parameters()),
                          "opt": state["opt"], "step": state["step"]})


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _fault_setup():
    cfg = get_config("qwen2.5-3b", smoke=True).replace(
        dtype=torch.float32, n_layers=1)
    tcfg = TrainConfig(opt=OptConfig(name="adamw", warmup=1),
                       microbatches=2, logdet_reg=0.05)
    state = init_train_state(cfg, tcfg, generator=torch.Generator()
                             .manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (4, 8)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(tok),
             "targets": torch.from_numpy(np.roll(tok, -1, 1))}
    return cfg, tcfg, state, batch


def test_fault_before_the_commit_point_leaves_the_state(monkeypatch):
    """A step that raises in its second microbatch's forward, or in the
    clip, leaves parameters, moments, count and step bitwise as they
    were; a good step then moves them."""
    cfg, tcfg, state, batch = _fault_setup()
    step = make_train_step(cfg, tcfg)
    before = _snapshot(state)
    bad = dict(batch, tokens=batch["tokens"].clone())
    bad["tokens"][3, 0] = cfg.vocab + 7          # microbatch 2, out of range
    with pytest.raises(IndexError):
        step(state, bad)
    assert _same(_snapshot(state), before)

    def boom(*a, **k):
        raise RuntimeError("injected fault in the clip")
    with monkeypatch.context() as m:
        m.setattr(TS, "clip_by_global_norm", boom)
        with pytest.raises(RuntimeError, match="injected"):
            make_train_step(cfg, tcfg)(state, batch)
    assert _same(_snapshot(state), before)

    state, metrics = step(state, batch)
    assert int(state["step"]) == 1 and int(state["opt"]["count"]) == 1
    assert not _same(_snapshot(state)["params"], before["params"])
    assert all(bool(torch.isfinite(v)) for v in metrics.values())

