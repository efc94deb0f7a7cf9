"""CPU twin of ``TrainConfig.cast_params_bf16`` against the JAX
package's jitted step (qwen2.5-3b's smoke config cut to one layer, sgd,
the logdet aux)."""
from __future__ import annotations

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
from repro_torch.models.convert import from_jax_train_state, unstacked
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, make_train_step


def test_cast_params_bf16_step_matches_jax():
    """cast_params_bf16: the forward runs on bf16 copies of the JAX-rank
    >= 2 f32 leaves (stacked norms among them) and the gradient reaches
    the f32 parameters, which stay f32.  One sgd step of qwen2.5-3b's
    smoke config cut to one layer against JAX's jitted step: metrics
    within 1e-5 (grad_norm 1e-4); each delta within one bf16 ulp (2^-7)
    of its parameter's largest delta, plus two f32 spacings of the
    parameter: a bf16 copy's gradient sums its uses (the tied embedding:
    lookup, unembedding and the aux) in bf16, in another order in each
    framework; and the loss moved off the uncast step's by the cast."""
    jcfg = jax_config("qwen2.5-3b", smoke=True).replace(dtype=jnp.float32,
                                                        n_layers=1)
    cfg = get_config("qwen2.5-3b", smoke=True).replace(dtype=torch.float32,
                                                       n_layers=1)
    params = jax.jit(lambda k: JM.init_model(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"tokens": tok, "targets": np.roll(tok, -1, 1)}
    losses = {}
    for cast in (False, True):
        opt = dict(name="sgd", lr=1e-2, warmup=1)
        jt = JTrainConfig(opt=JOptConfig(**opt), cast_params_bf16=cast,
                          logdet_reg=0.05)
        tt = TrainConfig(opt=OptConfig(**opt), cast_params_bf16=cast,
                         logdet_reg=0.05)
        jst = {"params": params, "opt": jax_optimizer(jt.opt)[0](params),
               "step": jnp.zeros((), jnp.int32)}
        np_state = jax.device_get(jst)
        jnew, jm = jax.jit(jax_train_step(jcfg, jt))(
            jst, {k: jnp.asarray(v) for k, v in batch.items()})
        state = from_jax_train_state(np_state, cfg, tt, device="cpu")
        state, m = make_train_step(cfg, tt)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses[cast] = float(m["loss"])
        if not cast:
            continue
        for k, want in jm.items():
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            assert float(m[k]) == pytest.approx(float(want), rel=rtol), k
        j0 = unstacked(np_state["params"])
        j1 = unstacked(jax.device_get(jnew["params"]))
        for k, p in state["params"].named_parameters():
            assert p.dtype == torch.float32, k
            dp = p.detach().double().numpy() - np.asarray(j0[k], np.float64)
            dj = np.asarray(j1[k], np.float64) - np.asarray(j0[k], np.float64)
            ulp = np.spacing(np.abs(np.asarray(j1[k], np.float32)))
            tol = 2.0 ** -7 * np.abs(dj).max() + 2 * ulp
            assert (np.abs(dp - dj) <= tol).all(), k
    assert losses[True] != losses[False]
