"""Shared twin checks of the port's train step (`repro_torch.train`)
against the JAX package's jitted ``make_train_step``.

One arch at its smoke config (f32 activations): the JAX parameters
(``init_model(PRNGKey(0))`` under ``jax.jit``, once per arch), the
optimizer's ``init`` on them and step 0 are the JAX state; the port's is
that tree carried across by `from_jax_train_state`.  Both take ONE step
on the same seeded numpy batch (B = 4, T = 16), with ``logdet_reg =
0.05`` (K1's route through the exact VJP; its plain version here) and
the case's optimizer settings (`CASES`).  Compared:

- the metrics (``loss``, ``nll``, ``logdet_reg``, each aux,
  ``grad_norm``) within METRIC_RTOL;
- the optimizer state leaf for leaf (the same JAX paths and stacked
  shapes) within STATE_RTOL of each element plus STATE_ATOL of the
  largest element of its kind (``m``, ``v``, ``vr``, ...), and the step;
  with gradient compression, plus what a bf16 rounding of each
  microbatch's gradient can change (COMPRESSION_ULP);
- the parameter deltas (new - old) of every parameter.  An adaptive
  optimizer divides each gradient element by its own scale, so where a
  gradient is rounding noise (the key bias ``bk``: its exact gradient
  is zero, as softmax ignores a shift shared by a row's scores) the two
  frameworks' noise moves that element by up to lr in either
  direction.  So each delta is held within DELTA_RTOL of itself, plus
  two f32 spacings of the parameter (each side rounds ``p - lr * s``),
  plus twice the delta's own sensitivity to a gradient error of
  GRAD_ATOL x the largest gradient element: the port's optimizer is
  applied to the port's clipped gradient (the one the step applied,
  captured from its clip) with +-GRAD_ATOL * max|g| random-signed
  perturbations (plus the compression bound), and the larger change of
  the delta is that element's sensitivity.  For SGD that term is lr *
  GRAD_ATOL * max|g|, so its case holds the gradients themselves to
  GRAD_ATOL.
"""
from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.optim.optimizers import OptConfig as JOptConfig
from repro.optim.optimizers import get_optimizer as jax_optimizer
from repro.train.step import TrainConfig as JTrainConfig
from repro.train.step import make_train_step as jax_train_step

from repro_torch.configs import get_config
from repro_torch.models.convert import flatten, from_jax_train_state, unstacked
from repro_torch.optim import (OptConfig, clip_by_global_norm, get_optimizer,
                               jax_leaves)
from repro_torch.train import TrainConfig, make_grad_fn, make_train_step
from repro_torch.train import step as TS

METRIC_RTOL = {"grad_norm": 1e-4, "default": 1e-5}
STATE_RTOL, STATE_ATOL = 1e-3, 1e-5
DELTA_RTOL, GRAD_ATOL = 1e-4, 1e-5
# grad_compression rounds each microbatch's gradient g_k to bf16: where
# the two frameworks' f32 g_k lie a rounding apart they may round to
# adjacent bf16 values, up to 2^-7 |g_k| apart; the mean over the
# microbatches then differs by up to COMPRESSION_ULP * mean_k |g_k|
COMPRESSION_ULP = 2.0 ** -7
LOGDET_REG = 0.05
XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}
BATCH, SEQ = 4, 16

# the optimizer cases: sgd (the twin of test_launch_integration.py::
# test_logdet_reg_training_uses_core), adamw with microbatches and bf16
# gradient compression, adafactor
CASES = {
    "sgd": {},
    "adamw": {"microbatches": 2, "grad_compression": True},
    "adafactor": {},
}


@functools.lru_cache(maxsize=None)
def jax_params(arch: str):
    """(JAX cfg, port cfg, the JAX parameters) at the smoke config, f32
    activations."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    params = jax.jit(lambda k: JM.init_model(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, params


def make_batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal(
            (BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def configs(name: str):
    kw = dict(CASES[name], logdet_reg=LOGDET_REG)
    return (JTrainConfig(opt=JOptConfig(name=name), **kw),
            TrainConfig(opt=OptConfig(name=name), **kw))


def _perturbed(grads, delta, sign, seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, x in grads.items():
        r = torch.randint(0, 2, x.shape, generator=g).to(x.dtype) * 2 - 1
        out[k] = x + sign * delta[k] * r
    return out


def _deltas(state, grads, tcfg):
    """The port optimizer's deltas on a copy of ``state``."""
    st = copy.deepcopy(state)
    old = {k: p.detach().clone() for k, p in st["params"].named_parameters()}
    get_optimizer(tcfg.opt)[1](grads, st["opt"], st["params"])
    return {k: p.detach().double() - old[k].double()
            for k, p in st["params"].named_parameters()}


def _compression_bound(cfg, tcfg, state, batch):
    """COMPRESSION_ULP * mean over the microbatches of |g_k| (f32, before
    any rounding), per parameter; zeros without compression."""
    if not tcfg.grad_compression:
        return None
    mb = tcfg.microbatches
    one = make_grad_fn(cfg, dataclasses.replace(
        tcfg, microbatches=1, grad_compression=False))
    acc = None
    for i in range(mb):
        part = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                for k, x in batch.items()}
        g, _ = one(state["params"], part)
        acc = {k: v.abs() if acc is None else acc[k] + v.abs()
               for k, v in g.items()}
    return {k: COMPRESSION_ULP * v / mb for k, v in acc.items()}


def run_case(arch: str, name: str) -> dict:
    jcfg, cfg, params = jax_params(arch)
    jt, tt = configs(name)
    jstate = {"params": params, "opt": jax_optimizer(jt.opt)[0](params),
              "step": jnp.zeros((), jnp.int32)}
    np_state = jax.device_get(jstate)
    batch = make_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # XLA's CPU backend at its lowest optimization level: the same program
    # (no fast-math at any level), compiled in about half the time
    jnew, jm = jax.jit(jax_train_step(jcfg, jt)).lower(jstate, jbatch) \
        .compile(XLA_FAST_COMPILE)(jstate, jbatch)
    jnew = jax.device_get(jnew)

    state = from_jax_train_state(np_state, cfg, tt, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    comp = _compression_bound(cfg, tt, state, tb)
    before = copy.deepcopy(state)
    old = {k: p.detach().clone()
           for k, p in state["params"].named_parameters()}
    seen = []

    def clip(grads, max_norm):
        out = clip_by_global_norm(grads, max_norm)
        seen.append(out[0])
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "clip_by_global_norm", clip)
        state, metrics = make_train_step(cfg, tt)(state, tb)
    # each delta's sensitivity to an error of the gradient the step applied
    grads = seen[0]
    gmax = max(float(g.abs().max()) for g in grads.values())
    delta = {k: GRAD_ATOL * gmax + (0 if comp is None else comp[k])
             for k in grads}
    base = _deltas(before, grads, tt)
    sens = {k: torch.zeros_like(v) for k, v in base.items()}
    for sign in (1.0, -1.0):
        d = _deltas(before, _perturbed(grads, delta, sign, 1), tt)
        sens = {k: torch.maximum(sens[k], (d[k] - base[k]).abs())
                for k in sens}
    return {"arch": arch, "name": name, "np_state": np_state, "jnew": jnew,
            "jm": {k: float(v) for k, v in jm.items()}, "state": state,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "old": old, "base": base, "sens": sens, "grads": grads,
            "comp": comp, "tcfg": tt}


def _state_bound(r, key):
    """Per element of the JAX optimizer-state leaf ``key`` ("m.blocks.w"),
    what gradient compression can change there (0 without it)."""
    if r["comp"] is None:
        return 0.0
    kind, _, path = key.partition(".")
    leaves = jax_leaves(r["state"]["params"])
    leaf = {".".join(x.path): x for x in leaves}[path]

    def stacked(d):
        return torch.stack([d[n] for n in leaf.names]).reshape(
            tuple(leaf.lead) + tuple(d[leaf.names[0]].shape)).double().numpy()
    e, g = stacked(r["comp"]), np.abs(stacked(r["grads"]))
    opt = r["tcfg"].opt
    if kind == "m":
        return (1 - opt.b1) * e
    if kind == "v":
        return (1 - opt.b2) * (2 * g * e + e * e)
    raise AssertionError(f"compression bound for {key}")


def check_case(r: dict) -> None:
    arch, name = r["arch"], r["name"]
    # metrics: the same keys, each within its tolerance
    assert set(r["metrics"]) == set(r["jm"]), (r["metrics"], r["jm"])
    for k, want in r["jm"].items():
        rtol = METRIC_RTOL.get(k, METRIC_RTOL["default"])
        got = r["metrics"][k]
        assert abs(got - want) <= rtol * abs(want), (arch, name, k, got, want)
    assert int(r["state"]["step"]) == int(r["jnew"]["step"]) == 1
    # the optimizer state, leaf for leaf
    want = flatten(r["jnew"]["opt"])
    got = flatten({k: v for k, v in r["state"]["opt"].items()})
    assert set(got) == set(want)

    def kind(k):
        return k.rsplit(".", 1)[-1] if name == "adafactor" else k.split(".")[0]
    scale = {}
    for k, v in want.items():
        scale[kind(k)] = max(scale.get(kind(k), 0.0), float(np.abs(v).max()))
    for k, v in want.items():
        g = np.asarray(got[k], np.float64)
        v = np.asarray(v, np.float64)
        assert g.shape == v.shape, k
        if k == "count":
            assert g == v == 1
            continue
        tol = (STATE_RTOL * np.abs(v) + STATE_ATOL * scale[kind(k)]
               + _state_bound(r, k))
        err = np.abs(g - v)
        assert (err <= tol).all(), (
            f"{arch} {name} opt.{k}: off by {err.max()} (tolerance "
            f"{tol.flat[err.argmax()]} there; max {np.abs(v).max()})")
    # the step applied is the port's optimizer on the port's gradient
    j0 = unstacked(r["np_state"]["params"])
    j1 = unstacked(r["jnew"]["params"])
    moved = 0
    for k, p in r["state"]["params"].named_parameters():
        dp = (p.detach().double() - r["old"][k].double())
        assert torch.equal(dp, r["base"][k]), (arch, name, k)
        pj0 = np.asarray(j0[k], np.float64)
        dj = np.asarray(j1[k], np.float64) - pj0
        ulp = np.spacing(np.abs(np.asarray(j1[k], np.float32))).astype(
            np.float64)
        tol = (DELTA_RTOL * np.abs(dj) + 2 * ulp
               + 2 * r["sens"][k].numpy())
        err = np.abs(dp.numpy() - dj)
        assert (err <= tol).all(), (
            f"{arch} {name} {k}: delta off by {err.max()} (tolerance "
            f"{tol.flat[err.argmax()]} there; |delta| {np.abs(dj).max()})")
        moved += int((dj != 0).any())
    assert moved > 0, "no parameter moved"
