"""The training step -- counterpart of `repro.train.step`: gradient
accumulation over microbatches, optional bf16 gradient compression,
global-norm clipping, the optional logdet-reg aux, and the optimizer
update.

The JAX step is one jitted function; here it is eager PyTorch, on the
device the state lives on.  The train state keeps the JAX keys:
``{"params": Model, "opt": <the optimizer's state in the JAX tree's
layout>, "step": 0-d int32}``.

**The commit point.**  The JAX step is functional, so a step that raises
leaves ``state`` as it was, and the fault-tolerant driver goes on from
it when there is no checkpoint yet.  The port updates in place, so
`make_train_step`'s step computes every microbatch's gradients, their
mean and the clip first, writing nothing; only then (the commit point,
marked in the code) does the optimizer write the parameters and the
moments, and the step count move.  A fault raised before the commit
point leaves the state bitwise as it was.

**On a mesh** (`repro_torch.sharding.layout.mesh_step`) the loss and the
gradient function run inside a data split (`repro_torch.sharding.split`)
and a model split (`repro_torch.sharding.tensor`) with the parameters
gathered one unit at a time (`repro_torch.sharding.fsdp`): each rank
computes on its share of every global microbatch and on its share of
the heads, mlp columns, experts and vocab rows, the loss's batch
statistics are reduced over the ranks, and each unit's gradient is
summed over them in the unit's backward (one all_sum a tensor), of
which the rank keeps its block -- then, as in the JAX step, compressed
and accumulated in ``accum_dtype`` in microbatch order, on the blocks
(elementwise: the same bits as the whole gradients' blocks).  The
metrics are the global batch's.  Outside the splits and a `fsdp.sharded`
scope nothing of that runs.

``cast_params_bf16`` casts each block before its gather, as each unit
is called.  One device takes a one-rank `fsdp.sharded` scope for it, so
that a checkpoint's recomputation under ``cfg.remat`` casts again, as
JAX casts inside the rematerialised function.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.models.common import ModelConfig, embed_lookup
from repro_torch.models.model import forward_hidden, init_model
from repro_torch.optim.optimizers import (
    OptConfig, clip_by_global_norm, get_optimizer, jax_ndim,
)
from repro_torch.sharding import fsdp, split
from repro_torch.train.loss import chunked_cross_entropy, logdet_decorrelation

__all__ = ["TrainConfig", "make_loss_fn", "make_grad_fn", "init_train_state",
           "make_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1          # grad accumulation steps per train step
    moe_aux_weight: float = 0.01
    logdet_reg: float = 0.0        # weight of the condensation-core aux loss
    grad_compression: bool = False # round f32 grads through bf16
    ce_chunk: int = 512            # seq chunk for the fused unembed+CE
    accum_dtype: Any = torch.float32  # grad-accumulation buffer dtype
    cast_params_bf16: bool = False # cast 2D+ (JAX rank) f32 params to bf16
                                   # before use; grads reach the f32 leaves


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(model, batch) -> (loss, metrics)``: chunked CE on
    `forward_hidden`, plus ``moe_aux_weight`` x each aux, plus
    ``logdet_reg`` x `logdet_decorrelation` of the mean-pooled token
    embeddings.  In a data split ``loss`` is this rank's share (its CE
    terms over the global count, the whole-batch aux terms, which every
    rank holds alike); the metrics count each term once."""
    def body(model, batch):
        hidden, aux = forward_hidden(model, batch)
        loss = chunked_cross_entropy(hidden, model.unembedding(),
                                     batch["targets"],
                                     softcap=cfg.logits_softcap,
                                     chunk=tcfg.ce_chunk, vocab=cfg.vocab)
        metrics = {"nll": split.whole(loss)}
        value = metrics["nll"]
        for k in sorted(aux):
            loss = loss + tcfg.moe_aux_weight * aux[k]
            value = value + tcfg.moe_aux_weight * aux[k]
            metrics[k] = aux[k]
        if tcfg.logdet_reg:
            # decorrelation on the mean-pooled token embeddings: the
            # framework-level use of the paper's logdet core
            emb = embed_lookup(model.embed, batch["tokens"], cfg.dtype,
                               cfg.vocab)
            reg = logdet_decorrelation(emb.mean(dim=1))
            loss = loss + tcfg.logdet_reg * reg
            value = value + tcfg.logdet_reg * reg
            metrics["logdet_reg"] = reg
        metrics["loss"] = value
        return loss, metrics

    rule = _bf16 if tcfg.cast_params_bf16 else None

    def loss_fn(model, batch):
        with _cast_scope(model, tcfg), fsdp.gathered(model, rule):
            return body(model, batch)
    return loss_fn


def _cast_scope(model, tcfg: TrainConfig):
    """Under ``cast_params_bf16`` on one device, a one-rank `fsdp.sharded`
    scope (every leaf whole, nothing summed), so that each unit casts its
    parameters as it is called -- a checkpoint's recomputation in the
    backward too, which must run inside the scope; else nothing."""
    if tcfg.cast_params_bf16 and not fsdp.installed(model):
        return fsdp.sharded(model)
    return contextlib.nullcontext()


def _bf16(name: str, p: torch.Tensor):
    """``cast_params_bf16``'s rule: bf16 for an f32 parameter whose JAX
    leaf has rank >= 2, else None."""
    if jax_ndim(name, p) >= 2 and p.dtype == torch.float32:
        return torch.bfloat16
    return None


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, *,
                     generator: Optional[torch.Generator] = None,
                     device=None):
    """A fresh train state, on the card unless ``device="cpu"``
    (parameters by `repro_torch.models.init_model`)."""
    params = init_model(cfg, generator=generator, device=device)
    opt_init, _ = get_optimizer(tcfg.opt)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(params.parameters()).device)
    return {"params": params, "opt": opt_init(params), "step": step}


def make_grad_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``grad_fn(model, batch) -> (grads, metrics)``: the first half of the
    step, before the clip.  ``grads`` maps every parameter name to its
    gradient (mean over the microbatches, in ``accum_dtype`` when there
    are several); nothing is written.  Under `fsdp.sharded` in a data
    split ``grads`` are this rank's blocks of the sums over the ranks."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def compress(g):
        if tcfg.grad_compression and g.dtype == torch.float32:
            return g.to(torch.bfloat16).to(torch.float32)
        return g

    def one_micro(model, names, params, mb):
        with _cast_scope(model, tcfg):
            loss, metrics = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [compress(torch.zeros_like(p) if g is None else g)
                 for g, p in zip(grads, params)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def grad_fn(model, batch):
        names, params = zip(*model.named_parameters())
        mb = tcfg.microbatches
        if mb > 1:
            def micro(i):
                return {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                        for k, x in batch.items()}
            adt = tcfg.accum_dtype
            grads, metrics = one_micro(model, names, params, micro(0))
            grads = [g.to(adt) for g in grads]
            for i in range(1, mb):
                g, m = one_micro(model, names, params, micro(i))
                grads = [a + x.to(adt) for a, x in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            inv = 1.0 / mb
            # grads stay in accum_dtype: the clip and the optimizer cast
            # per leaf
            grads = [g * torch.tensor(inv, dtype=g.dtype) for g in grads]
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            grads, metrics = one_micro(model, names, params, batch)
        return dict(zip(names, grads)), metrics

    return grad_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place (after the commit point) and returns it.
    ``metrics`` are 0-d tensors on the state's device: ``nll``, each
    aux, ``logdet_reg`` (with ``tcfg.logdet_reg``), ``loss`` (means over
    the microbatches) and ``grad_norm`` (before the clip)."""
    grad_fn = make_grad_fn(cfg, tcfg)
    _, opt_update = get_optimizer(tcfg.opt)

    def train_step(state, batch):
        model = state["params"]
        grads, metrics = grad_fn(model, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.clip_norm)
        # ---- the commit point: nothing above wrote the state ----
        opt_update(grads, state["opt"], model)
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return state, metrics

    return train_step
