"""Sharding rules: parameter path -> logical axes -> mesh partition specs
-- counterpart of `repro.sharding.rules`.

Two levels, as in the JAX package:

  1. *Logical axes* per parameter, resolved from the leaf's name (every
     parameter name of `repro_torch.models` is unique per role; the
     names are the JAX ones) and its rank: extra leading dims are
     layer-stack axes and map to None.
  2. *Rules* mapping logical axis -> mesh axis (or None), built per
     (config, mesh): ``embed`` on the FSDP axes ("data", or ("pod",
     "data")), ``heads``/``mlp``/``vocab``/``expert``/``inner`` on
     "model", ``kv_heads`` on "model" only when divisible.

The port's model keeps one module per layer, where the JAX tree stacks
layers on leading axes, so a port parameter's spec is the JAX stacked
leaf's spec without its leading Nones (the rules never shard a stack
axis).  The optimizer state keeps the JAX stacked layout
(`repro_torch.optim`), so its specs are the JAX ones.

A mesh here is anything with ``.shape`` (a dict of axis sizes) and
``.axis_names``: `repro_torch.launch.mesh.GridMesh`, the shape-only
production mesh, or a test's stand-in.  `PartitionSpec` is a tuple of
``None``, an axis name or a tuple of names, one entry per leading dim;
`Sharding` pairs it with its mesh (the counterparts of JAX's
``PartitionSpec`` and ``NamedSharding``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["PartitionSpec", "Sharding", "make_rules", "param_specs",
           "param_shardings", "batch_spec", "cache_shardings",
           "logical_axes_for", "tree_map", "MODEL_PARALLEL"]


class PartitionSpec(tuple):
    """``PartitionSpec(None, "data", ("pod", "data"))``: one entry per
    leading dim, a dim past the last entry unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


# param-name -> logical axes (rightmost-aligned against the leaf rank)
_NAME_AXES: Dict[str, Tuple[str, ...]] = {
    "embed": ("vocab", "embed"),
    "head": ("vocab", "embed"),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "we_gate": ("expert", "embed", "mlp"),   # routed experts (EP axis)
    "we_up": ("expert", "embed", "mlp"),
    "we_down": ("expert", "mlp", "embed"),
    "router": ("embed", "expert"),
    "in_proj": ("embed", "inner"),
    "out_proj": ("inner", "embed"),
    "conv_w": ("null", "inner"),
    "conv_b": ("inner",),
    "A_log": ("null",),
    "D": ("null",),
    "dt_bias": ("null",),
    "norm": ("embed",),
    "scale": ("embed",),
    "attn_norm": ("embed",),
    "mlp_norm": ("embed",),
    "xattn_norm": ("embed",),
    "final_norm": ("embed",),
    "enc_norm": ("embed",),
    "xattn_gate": ("null",),
    "mlp_gate": ("null",),
}


# the leaves whose "model" split the port's step computes on, each rank
# its heads, mlp columns, experts or vocab rows (`sharding.tensor`).  The
# rules also split MoE's router and the SSM blocks' ``inner`` leaves on
# "model"; the step gathers those whole over the model line and computes
# them alike there: every rank routes every token, and the rules'
# contiguous block of the SSM's concatenated [z | x | B | C | dt]
# projection is not a set of whole heads
MODEL_PARALLEL = ("embed", "head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
                  "w_gate", "w_up", "w_down", "we_gate", "we_up", "we_down")


def _key(k) -> Optional[str]:
    """A path entry's name: a string, or a JAX-style key's ``.key``; a
    sequence index has none."""
    if isinstance(k, str):
        return k
    return getattr(k, "key", None)


def logical_axes_for(path, leaf) -> Tuple[Optional[str], ...]:
    """Logical axes for one leaf, from its path and rank.

    Also resolves optimizer-state leaves: Adam moments share the
    parameter's path suffix (same shape, same spec); Adafactor's factored
    moments end in "vr" (last dim dropped) / "vc" (second-to-last
    dropped); scalars ("count", "step") are replicated.
    """
    name = None
    last = None
    for k in path:
        key = _key(k)
        last = key if key is not None else last
        if key in _NAME_AXES:
            name = key
    rank = len(leaf.shape)
    if name is None:
        if rank == 0:
            return ()
        raise ValueError(f"no sharding rule for param path {path}")
    axes: Tuple[str, ...] = _NAME_AXES[name]
    if last == "vr":                       # adafactor row stats: drop last dim
        axes = axes[:-1]
    elif last == "vc":                     # col stats: drop 2nd-to-last dim
        axes = axes[:-2] + axes[-1:]
    if rank < len(axes):
        raise ValueError(f"{path}: rank {rank} < axes {axes}")
    return (None,) * (rank - len(axes)) + tuple(axes)


def _divisible(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(cfg, mesh, *, fsdp: bool = True) -> Dict[str, Optional[object]]:
    """logical axis -> mesh axis (or None), adapted to cfg divisibility.

    Serve/train-agnostic: FSDP stays on for serving too, so there is no
    ``kind`` knob here -- `batch_spec` is where train/serve/decode differ.
    """
    model_ax = "model" if "model" in mesh.axis_names else None
    data_axes = _data_axes(mesh)
    msize = mesh.shape.get("model", 1)
    fsdp_ax = data_axes if (fsdp and data_axes) else None
    return {
        "vocab": model_ax,
        "embed": fsdp_ax,
        "heads": model_ax if _divisible(cfg.n_heads, msize) else None,
        "kv_heads": model_ax if _divisible(cfg.n_kv_heads, msize) else None,
        "head_dim": None,
        "mlp": model_ax,
        "expert": model_ax if cfg.n_experts else None,
        "inner": model_ax,
        "conv": None,
        "null": None,
        "layer": None,
    }


def _spec_from_axes(axes, rules, mesh, shape) -> PartitionSpec:
    """Every entry must EVENLY divide its dim (no padding), and a mesh
    axis appears at most once."""
    entries = []
    used = set()
    for ax, dim in zip(axes, shape):
        m = rules.get(ax) if ax is not None else None
        if m is None:
            entries.append(None)
            continue
        ms = tuple(m) if isinstance(m, tuple) else (m,)
        ms = tuple(a for a in ms if a not in used)
        # drop trailing axes until the product divides the dimension
        while ms and dim % math.prod(mesh.shape[a] for a in ms) != 0:
            ms = ms[:-1]
        used.update(ms)
        entries.append(ms if ms else None)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a state tree: an ``nn.Module`` becomes a
    dict of its parameter names (the port's ``blocks.3.attn.wq``, path
    entries split at the dots), dicts and lists/tuples keep their type,
    ``None`` stays ``None``; a leaf is a tensor or a `PartitionSpec`."""
    if isinstance(tree, torch.nn.Module):
        return {name: fn(path + tuple(name.split(".")), t)
                for name, t in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(tree_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def param_specs(params_or_specs, cfg, rules, mesh):
    """A tree of `PartitionSpec`s matching a parameter tree, a train
    state or an optimizer state (tensors of any device, ``meta``
    included)."""
    return tree_map(lambda path, t: _spec_from_axes(
        logical_axes_for(path, t), rules, mesh, t.shape), params_or_specs)


def param_shardings(params_or_specs, cfg, mesh, **kw):
    rules = make_rules(cfg, mesh, **kw)
    return tree_map(lambda path, t: Sharding(mesh, _spec_from_axes(
        logical_axes_for(path, t), rules, mesh, t.shape)), params_or_specs)


def batch_spec(cfg, mesh, *, kind: str,
               batch: int | None = None) -> Dict[str, PartitionSpec]:
    """Specs of the model-input batch dict.  ``batch`` (when known) gates
    the data-parallel sharding: a global batch that doesn't divide the
    data axes (long_500k: batch=1) is replicated."""
    data_axes = _data_axes(mesh)
    if batch is not None and data_axes:
        if batch % math.prod(mesh.shape[a] for a in data_axes):
            data_axes = ()
    bspec = data_axes if data_axes else None
    out = {"tokens": P(bspec, None)}
    if kind == "train":
        out["targets"] = P(bspec, None)
    if cfg.family == "encdec":
        key = "memory" if kind == "decode" else "frames"
        out[key] = P(bspec, None, None)
    if cfg.family == "vlm":
        out["img_embeds"] = P(bspec, None, None)
    return out


def cache_shardings(cache_specs_tree, cfg, mesh):
    """KV/SSM cache specs for serving, over `models.cache_specs`' tree.

    Attention KV (..., B, S, kvh, hd): batch on data axes; heads on model
    if divisible, else the sequence dim on model (sequence-parallel KV).
    SSM conv (..., B, W, convdim) / state (..., B, nh, hp, st): batch on
    data, inner dims on model.
    """
    data_axes = _data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in data_axes) if data_axes else 1
    msize = mesh.shape.get("model", 1)
    model_ax = "model" if "model" in mesh.axis_names else None
    heads_ok = _divisible(cfg.n_kv_heads, msize)
    hd_ok = _divisible(cfg.hd if cfg.n_heads else 0, msize)

    def spec_for(path, leaf):
        shape = leaf.shape
        names = list(path)
        if any(n in ("k", "v") for n in names):
            # (layers..., B, S, kvh, hd).  NEVER shard S when batch
            # divides: the decode write lands at a position along S
            lead = (None,) * (len(shape) - 4)
            if _divisible(shape[-4], dsize):
                if heads_ok:
                    return P(*lead, data_axes or None, None, model_ax, None)
                if hd_ok:
                    return P(*lead, data_axes or None, None, None, model_ax)
                return P(*lead, data_axes or None, model_ax, None, None)
            # tiny batch (long_500k): S carries the data axes (masked-write
            # decode -- hints.configure(kv_masked_write=True))
            if heads_ok:
                return P(*lead, None, data_axes or None, model_ax, None)
            if hd_ok:
                return P(*lead, None, data_axes or None, None, model_ax)
            seq_axes = tuple(data_axes) + ((model_ax,) if model_ax else ())
            return P(*lead, None, seq_axes or None, None, None)
        if "conv" in names:
            lead = (None,) * (len(shape) - 3)
            batch_ok = _divisible(shape[-3], dsize)
            conv_ok = _divisible(shape[-1], msize)
            return P(*lead, data_axes if batch_ok else None, None,
                     model_ax if conv_ok else None)
        if "ssm" in names:
            # (layers..., B, nh, hp, st)
            lead = (None,) * (len(shape) - 4)
            batch_ok = _divisible(shape[-4], dsize)
            nh_ok = _divisible(shape[-3], msize)
            return P(*lead, data_axes if batch_ok else None,
                     model_ax if nh_ok else None, None, None)
        raise ValueError(f"unknown cache leaf {names}")

    return tree_map(spec_for, cache_specs_tree)
