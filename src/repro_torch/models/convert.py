"""Carry a JAX parameter tree across into the port's model.

`from_jax_params(tree, cfg)` takes the nested dict that the JAX package's
``init_model`` returns, with numpy arrays as leaves (``jax.device_get``
gives that), and returns a `repro_torch.models.Model` holding the same
numbers.  The JAX tree stacks layers on leading axes; the port keeps one
module per layer, so each stacked leaf is unstacked into ``ModuleList``
indices: one level for ``blocks``, two for the (n, per, ...) stacks of
llama4's dense blocks, vision's self blocks and zamba2's SSM blocks.

A bf16 leaf arrives as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses: it is widened to f32, which is exact, and
cast to the parameter's dtype.  `from_jax_train_state` carries a whole
JAX ``init_train_state`` tree across: the parameters as above, the
optimizer state as the stacked tensors it is (`repro_torch.optim` keeps
the JAX layout) and the step.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.estimators.operators.base import resolve_device
from repro_torch.models.common import ModelConfig, empty_init
from repro_torch.models.model import Model

__all__ = ["from_jax_params", "from_jax_train_state", "flatten", "unstacked",
           "STACK_DEPTH"]

# stacked leading axes of the JAX tree, by top-level key
STACK_DEPTH = {"blocks": 1, "moe_blocks": 1, "enc_blocks": 1,
                "dec_blocks": 1, "cross_blocks": 1, "extra_ssm": 1,
                "dense_blocks": 2, "self_blocks": 2, "ssm_blocks": 2}


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {"a.b.c": leaf}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _unstack(name: str, leaf: np.ndarray, depth: int) -> Dict[str, np.ndarray]:
    top, _, rest = name.partition(".")
    if depth == 0:
        return {name: leaf}
    out = {}
    for i in range(leaf.shape[0]):
        for sub, v in _unstack(f"{top}.{rest}", leaf[i], depth - 1).items():
            head, _, tail = sub.partition(".")
            out[f"{head}.{i}.{tail}"] = v
    return out


def unstacked(tree) -> Dict[str, np.ndarray]:
    """A JAX parameter tree (or a tree of its gradients) as the port's
    parameter names -> numpy arrays (views of the stacked leaves)."""
    out: Dict[str, np.ndarray] = {}
    for name, leaf in flatten(tree).items():
        depth = STACK_DEPTH.get(name.partition(".")[0], 0)
        out.update(_unstack(name, leaf, depth))
    return out


def _tensor(leaf: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if leaf.dtype.kind == "V" or leaf.dtype.name == "bfloat16":
        leaf = leaf.astype(np.float32)
    return torch.from_numpy(np.array(leaf)).to(dtype)


def from_jax_params(tree, cfg: ModelConfig, *, device=None) -> Model:
    """The port's model with the numbers of a JAX ``init_model`` tree, on
    the card unless ``device="cpu"``.  Every parameter must be present
    and of the JAX shape."""
    dev = resolve_device(device)
    model = Model(cfg, empty_init(dev))
    want = dict(model.named_parameters())
    state = {}
    for key, v in unstacked(tree).items():
        if key not in want:
            raise KeyError(f"{key}: not a parameter of the port's model")
        if tuple(v.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: shape {v.shape} != "
                             f"{tuple(want[key].shape)}")
        state[key] = _tensor(v, want[key].dtype)
    missing = set(want) - set(state)
    if missing:
        raise KeyError(f"parameters missing from the JAX tree: "
                       f"{sorted(missing)}")
    model.load_state_dict(state, strict=True)
    return model


def _opt_from(tree, want, path, dev):
    """The JAX optimizer state ``tree`` (numpy leaves) as tensors shaped
    and typed as the port's own state ``want``."""
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else tree
            raise KeyError(f"opt{path}: JAX keys {got} != the port's "
                           f"{sorted(want)}")
        return {k: _opt_from(tree[k], want[k], f"{path}.{k}", dev)
                for k in want}
    leaf = np.asarray(tree)
    if tuple(leaf.shape) != tuple(want.shape):
        raise ValueError(f"opt{path}: shape {leaf.shape} != "
                         f"{tuple(want.shape)}")
    return _tensor(leaf, want.dtype).to(dev)


def from_jax_train_state(tree, cfg: ModelConfig, tcfg, *, device=None):
    """The port's train state (`repro_torch.train.step.init_train_state`'s
    layout: ``{"params": Model, "opt": ..., "step": 0-d int32}``) with the
    numbers of a JAX ``init_train_state`` tree (numpy leaves), on the
    card unless ``device="cpu"``.  ``tcfg`` (a `TrainConfig`) names the
    optimizer, whose state must match the port's leaf for leaf."""
    from repro_torch.optim import get_optimizer
    dev = resolve_device(device)
    model = from_jax_params(tree["params"], cfg, device=dev)
    init, _ = get_optimizer(tcfg.opt)
    opt = _opt_from(tree["opt"], init(model), "", dev)
    step = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                        device=dev)
    return {"params": model, "opt": opt, "step": step}
