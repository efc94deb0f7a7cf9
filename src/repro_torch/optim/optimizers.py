"""Optimizers (AdamW, Adafactor, SGD), the schedule and the gradient
utilities -- counterpart of `repro.optim.optimizers`.

Explicit tensor code under ``torch.no_grad()``, not ``torch.optim``
classes: ``torch.optim.AdamW`` decays every tensor it is given, and
torch has no Adafactor with this RMS-1 clip and factoring.  Moments are
always f32.

**The JAX tree's layout.**  The JAX package stacks every layer on
leading axes (``_stack_init``), and three of its rules act on the
stacked leaf, not on one layer's tensor: AdamW decays ``p.ndim >= 2``
leaves, so a per-layer norm scale ``(d,)``, which is an ``(L, d)`` leaf
there, IS decayed; Adafactor factors ``p.ndim >= 2`` leaves, so that
leaf gets ``vr`` ``(L,)`` and ONE ``vc`` ``(d,)`` shared by all layers,
and its RMS-1 update clip takes the mean over the whole stacked leaf;
and ``cast_params_bf16`` casts ``p.ndim >= 2`` leaves.  The port keeps
one module per layer, so the optimizer works in the JAX layout:
`jax_leaves` groups the port's per-layer parameters by their JAX leaf
path, an update stacks a group's parameters and gradients into the JAX
leaf's shape, applies the JAX rule to it and writes the result back
into each layer's parameter with ``copy_``.  The state is the JAX
package's, leaf for leaf: nested dicts keyed by the JAX path, holding
stacked f32 tensors, and ``count`` a 0-d int32 on the parameters'
device.  So the JAX state carries across one to one
(`repro_torch.models.convert.from_jax_train_state`) and a checkpoint
names the optimizer's leaves as the JAX package does.

``params`` is an ``nn.Module`` (its ``named_parameters``) or a dict of
the port's parameter names (``"blocks.3.attn.wq"``) to tensors;
``grads`` a dict of the same names, where a missing or ``None`` entry
counts as zeros (JAX's gradient of an unused leaf).  ``update(grads,
state, params) -> (params, state)`` writes both in place and returns
them.

**On blocks** (the step on a mesh, `repro_torch.sharding.layout
.mesh_step`): ``params``, ``state`` and ``grads`` hold this rank's
blocks, every leaf of the optimizer state in the block the sharding
rules give it.  AdamW and SGD are elementwise: the update of a block is
bitwise that block of the whole update.  Adafactor's factored moments
are means over a dim of the whole leaf (``vr`` over the last, ``vc``
over the second to last, and ``vr``'s own mean), and its RMS-1 clip is
over the whole stacked leaf, so ``update(..., split=...)`` maps each
parameter name to its `BlockSplit` (every layer of a JAX leaf splits
alike, and no rule splits a stack axis): each mean over a dim that a
mesh axis splits is the sum of the ranks' partial sums over the line of
that axis, by one collective a dependent round (the rows; the columns
with ``vr``'s mean; the clip's sum of squares), over the whole dim's
length.  A leaf that no axis splits sums nothing and steps bitwise as on
one device.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.convert import STACK_DEPTH

__all__ = ["OptConfig", "lr_at", "global_norm", "clip_by_global_norm",
           "get_optimizer", "OPTIMIZERS", "BlockSplit", "JaxLeaf",
           "jax_leaves",
           "jax_ndim", "adamw_init", "adamw_update", "adafactor_init",
           "adafactor_update", "sgd_init", "sgd_update"]


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: a 0-d f32
    tensor on ``step``'s device (the CPU for a Python int)."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
    else:
        s = torch.tensor(float(step), dtype=torch.float32)
    warm = cfg.lr * torch.clamp((s + 1) / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.decay_steps - cfg.warmup, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup, warm, cfg.lr * cos)


def _values(grads):
    return list(grads.values()) if isinstance(grads, dict) else list(grads)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _values(grads)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale every gradient by min(1, max_norm / norm) in f32 and cast it
    back to its dtype -> (grads, norm); a dict stays a dict.  ``norm``
    defaults to `global_norm` of ``grads`` (a mesh step gives the norm of
    the whole gradients it holds blocks of)."""
    g = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)

    def clip(x):
        return (x.to(torch.float32) * scale).to(x.dtype)
    if isinstance(grads, dict):
        return {k: clip(x) for k, x in grads.items()}, g
    return [clip(x) for x in grads], g


# ---------------------------------------------------------------------------
# the JAX tree's leaves over the port's per-layer parameters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JaxLeaf:
    """One leaf of the JAX tree: its path, the port's parameters that
    stack into it (row-major over the leading axes) and those axes."""
    path: Tuple[str, ...]
    names: Tuple[str, ...]
    lead: Tuple[int, ...]


@dataclass(frozen=True)
class BlockSplit:
    """How a mesh cuts one parameter (a layer of its JAX leaf) into this
    rank's block: ``whole``, the whole parameter's shape; ``dims``, each
    split dim (negative, so that it names the stacked leaf's dim too) and
    the mesh axes that split it; ``sum(ts, axes)``, each tensor of ``ts``
    summed over this rank's line along ``axes`` (the ranks that hold the
    other blocks there), all in one collective, the same bits on every
    rank of the line."""
    whole: Tuple[int, ...]
    dims: Dict[int, Tuple[str, ...]]
    sum: Callable[[List[torch.Tensor], Tuple[str, ...]], List[torch.Tensor]]

    def axes(self, dims=None) -> Tuple[str, ...]:
        """The axes that split any of ``dims`` (every split dim: None)."""
        return tuple(a for d, ax in sorted(self.dims.items())
                     if dims is None or d in dims for a in ax)


def _split(name: str):
    parts = name.split(".")
    depth = STACK_DEPTH.get(parts[0], 0)
    idx = tuple(int(i) for i in parts[1:1 + depth])
    return (parts[0],) + tuple(parts[1 + depth:]), idx


def jax_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of the JAX leaf that the port's parameter ``name`` is a
    layer of: its own rank plus its stack depth."""
    return t.dim() + STACK_DEPTH.get(name.partition(".")[0], 0)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def jax_leaves(params) -> List[JaxLeaf]:
    """The JAX leaves of a parameter set, in the JAX tree's order (sorted
    paths)."""
    groups: Dict[tuple, list] = {}
    for name in _named(params):
        path, idx = _split(name)
        groups.setdefault(path, []).append((idx, name))
    out = []
    for path in sorted(groups):
        items = sorted(groups[path])
        idxs = [i for i, _ in items]
        lead = tuple(max(c) + 1 for c in zip(*idxs)) if idxs[0] else ()
        if math.prod(lead) != len(items):
            raise ValueError(f"{'.'.join(path)}: layers {idxs} do not fill "
                             f"a {lead} stack")
        out.append(JaxLeaf(path, tuple(n for _, n in items), lead))
    return out


def _stack(ts: List[torch.Tensor], lead) -> torch.Tensor:
    if not lead:
        return ts[0]
    return torch.stack(ts).reshape(tuple(lead) + tuple(ts[0].shape))


def _write(ps: List[torch.Tensor], new: torch.Tensor, lead) -> None:
    if not lead:
        ps[0].copy_(new)
        return
    for p, x in zip(ps, new.reshape((-1,) + tuple(ps[0].shape))):
        p.copy_(x)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _device(named) -> torch.device:
    return next(iter(named.values())).device if named else torch.device("cpu")


def _leaf_tensors(leaf: JaxLeaf, named, grads):
    """(the layers' parameters, the stacked parameter, the stacked f32
    gradient) of one JAX leaf; a missing gradient is zeros of its
    parameter's shape."""
    ps = [named[n] for n in leaf.names]
    gs = [grads.get(n) if grads.get(n) is not None
          else torch.zeros_like(p) for n, p in zip(leaf.names, ps)]
    return ps, _stack(ps, leaf.lead), _stack(gs, leaf.lead).to(
        torch.float32)


def _count(named) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(named))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params):
    named = _named(params)
    m, v = {}, {}
    for leaf in jax_leaves(named):
        p = named[leaf.names[0]]
        shape = tuple(leaf.lead) + tuple(p.shape)
        _put(m, leaf.path, torch.zeros(shape, dtype=torch.float32,
                                       device=p.device))
        _put(v, leaf.path, torch.zeros(shape, dtype=torch.float32,
                                       device=p.device))
    return {"m": m, "v": v, "count": _count(named)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    named = _named(params)
    c = state["count"] + 1
    cf = c.to(torch.float32)
    lr = lr_at(cfg, state["count"])
    b1, b2 = cfg.b1, cfg.b2
    for leaf in jax_leaves(named):
        ps, p, g = _leaf_tensors(leaf, named, grads)
        m_ref, v_ref = _get(state["m"], leaf.path), _get(state["v"], leaf.path)
        m = b1 * m_ref + (1 - b1) * g
        v = b2 * v_ref + (1 - b2) * g * g
        mh = m / (1 - b1 ** cf)
        vh = v / (1 - b2 ** cf)
        step = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:                     # decoupled decay on matrices only
            step = step + cfg.weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * step).to(p.dtype)
        m_ref.copy_(m)
        v_ref.copy_(v)
        _write(ps, new, leaf.lead)
    state["count"].copy_(c)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; no first moment)
# ---------------------------------------------------------------------------

def adafactor_init(params):
    named = _named(params)
    f = {}
    for leaf in jax_leaves(named):
        p = named[leaf.names[0]]
        shape = tuple(leaf.lead) + tuple(p.shape)

        def zeros(s):
            return torch.zeros(s, dtype=torch.float32, device=p.device)
        if len(shape) >= 2:
            _put(f, leaf.path, {"vr": zeros(shape[:-1]),
                                "vc": zeros(shape[:-2] + shape[-1:])})
        else:
            _put(f, leaf.path, {"v": zeros(shape)})
    return {"f": f, "count": _count(named)}


def _means(cut: Optional[BlockSplit], dim: int, xs):
    """The whole leaf's means over ``dim`` of each block of ``xs`` (each
    reduced over its own ``dim`` entry of ``xs``: (x, its dim)): where no
    axis splits the leaf's ``dim``, ``x.mean(d)`` itself; else the sums
    over the line that splits it, in one collective, over the whole
    dim's length."""
    axes = () if cut is None else cut.axes((dim,))
    if not axes:
        return [x.mean(dim=d) for x, d in xs]
    n = cut.whole[dim]
    return [s / n for s in cut.sum([x.sum(dim=d) for x, d in xs], axes)]


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params, split=None):
    named = _named(params)
    c = state["count"] + 1
    lr = lr_at(cfg, state["count"])
    decay = 1.0 - c.to(torch.float32) ** -0.8
    for leaf in jax_leaves(named):
        ps, p, g = _leaf_tensors(leaf, named, grads)
        f = _get(state["f"], leaf.path)
        cut = None if split is None else split[leaf.names[0]]
        g2 = g * g + 1e-30
        if p.dim() >= 2:
            # rounds: the rows, then the columns with vr's mean (vr's last
            # dim is the leaf's second to last)
            rows, = _means(cut, -1, [(g2, -1)])
            vr = decay * f["vr"] + (1 - decay) * rows
            cols, vr_mean = _means(cut, -2, [(g2, -2), (vr, -1)])
            vc = decay * f["vc"] + (1 - decay) * cols
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr_mean[..., None, None], min=1e-30))
            step = g * torch.rsqrt(denom + 1e-30)
            new_f = {"vr": vr, "vc": vc}
        else:
            v = decay * f["v"] + (1 - decay) * g2
            step = g * torch.rsqrt(v + 1e-30)
            new_f = {"v": v}
        # update clipping (Adafactor's RMS-1 rule), over the whole JAX leaf
        axes = () if cut is None else cut.axes()
        if axes:
            sq, = cut.sum([torch.sum(step * step).reshape(1)], axes)
            n = math.prod(leaf.lead) * math.prod(cut.whole)
            rms = torch.sqrt(sq.reshape(()) / n + 1e-30)
        else:
            rms = torch.sqrt(torch.mean(step * step) + 1e-30)
        step = step / torch.clamp(rms, min=1.0)
        if p.dim() >= 2:
            step = step + cfg.weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr * step).to(p.dtype)
        for k, x in new_f.items():
            f[k].copy_(x)
        _write(ps, new, leaf.lead)
    state["count"].copy_(c)
    return params, state


# ---------------------------------------------------------------------------
# SGD (tests/toys)
# ---------------------------------------------------------------------------

def sgd_init(params):
    return {"count": _count(_named(params))}


@torch.no_grad()
def sgd_update(cfg: OptConfig, grads, state, params):
    named = _named(params)
    lr = lr_at(cfg, state["count"])
    for leaf in jax_leaves(named):
        ps, p, g = _leaf_tensors(leaf, named, grads)
        new = (p.to(torch.float32) - lr * g).to(p.dtype)
        _write(ps, new, leaf.lead)
    state["count"].add_(1)
    return params, state


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "sgd": (sgd_init, sgd_update),
}


def get_optimizer(cfg: OptConfig):
    """(init(params) -> state, update(grads, state, params) -> (params,
    state)); Adafactor's update also takes ``split=`` on a mesh (each
    parameter name's `BlockSplit`; see the module docstring)."""
    init, update = OPTIMIZERS[cfg.name]
    return init, functools.partial(update, cfg)
