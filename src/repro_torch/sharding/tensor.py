"""The model split of a training step: tensor and expert parallel on the
"model" axis of a mesh -- what GSPMD does to the JAX step's heads, mlp,
vocab, expert and SSM inner dims on that axis (`repro.sharding.rules`),
for a port whose ranks are processes.

Inside `model_split(line)` each rank of ``line`` (the ranks that differ
only along "model", `launch.mesh.GridMesh.line`) computes its share of
every leaf the rules split on "model": the unit gather (`sharding.fsdp`)
hands it its model block of such a leaf, gathered over its data line
only, and the model code reads the block's shape (`share`): a module
whose leaf is whole computes alike on every rank of the line, as on one
rank.  The products follow the Megatron pattern:

- a column-parallel product (the q / k / v projections, ``w_gate`` and
  ``w_up``, the experts' inputs, the unembedding) reads its input
  through `to_model`: the identity forward, and in the backward one
  all_sum of the ranks' partial input gradients;
- a row-parallel product (``wo``, ``w_down``, the experts' outputs, the
  vocab-parallel embedding lookup) hands its partial output to
  `from_model`: one all_sum forward, the identity backward.

So everything between the two is computed alike on every rank of the
line, bitwise (one all_sum gives every rank the same bits, as in
`split`), and the gradient that reaches a replicated leaf there is
already the sum (the norms, the router: MoE's combine weights also go
through `to_model`).  Two kinds of leaf are not: a leaf the rank keeps
a block of (``split``: its gradient is its block's), and an attention's
k / v projection kept whole while the q heads split (``partial``: each
rank's q heads read only their kv groups, so each rank's gradient is a
part, and the unit's reduction sums it over the data and model lines at
once, `leaf_modes`).  MoE's router is gathered whole over the line and
computed alike (it is not in `rules.MODEL_PARALLEL`).

The SSM blocks (mamba2's, zamba2's) split by their heads where the SSM
heads (``cfg.nh_ssm``) divide the model line (`ssm_splits`); the rank
computes heads ``[r nh/M, (r+1) nh/M)``:

- ``out_proj`` is `SPLIT`: its rules block, rows ``[r d_inner/M,
  (r+1) d_inner/M)``, is the rank's heads' rows; row-parallel, its
  partial output goes through `from_model`;
- every other leaf of the SSM module is `PARTIAL`, gathered whole:
  ``in_proj`` (the rank's product reads its heads' z, x and dt columns
  and the whole B / C, one group; its input through `to_model`), ``conv_w`` / ``conv_b`` (the depthwise conv on the rank's
  channels), ``A_log``, ``D``, ``dt_bias`` and the gated norm's
  ``norm`` scale (sliced to the rank's heads).  The gated RMSNorm spans
  every rank's heads: each rank sums the squares of its f32 slice and
  `sum_model` adds the (B, T, 1) sums over the line, one all_sum forward
  and one backward.

Where the SSM heads do not divide the line, every SSM leaf is `FULL` and
the layer runs whole on every rank of the line.

The cross-entropy over a vocab-parallel unembedding exchanges each
rank's logits maximum, its sum of exponentials and its target logit
(`each`: one all_sum of a zero-padded stack) and takes the global
log-sum-exp from them (`train.loss`).

Only ``all_reduce`` is used: gloo takes CUDA tensors for it and
``broadcast`` alone.  The split in force is the process's, not a
thread's (a checkpoint's recomputation runs on the autograd engine's
thread on the card).  A line of one rank, or no `model_split`, splits
nothing.  ``model_split(size=M, rank=r)`` without a line is shape only
(the dry run on meta tensors): the model code computes rank ``r``'s
share, and nothing is exchanged.
"""
from __future__ import annotations

import types
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.core import mesh as core_mesh
from repro_torch.sharding import split

__all__ = ["ModelSplit", "model_split", "current", "share", "recording",
           "to_model", "from_model", "sum_model", "each", "leaf_modes",
           "ssm_splits", "SPLIT", "PARTIAL", "FULL"]

_STATE = types.SimpleNamespace(split=None)

# how a unit's leaf is gathered and reduced under a model split
SPLIT, PARTIAL, FULL = "split", "partial", "full"


@dataclass(frozen=True)
class ModelSplit:
    """``size`` ranks share every leaf split on "model", this one being
    ``rank``; ``line`` is their `core.mesh.Mesh` (None: shape only)."""
    size: int
    rank: int
    line: Optional[core_mesh.Mesh] = None


@contextmanager
def model_split(line: Optional[core_mesh.Mesh] = None, *,
                size: Optional[int] = None, rank: int = 0):
    """The model code inside computes this rank's share of the leaves
    split over ``line`` (or, shape only, rank ``rank`` of ``size``)."""
    prev = _STATE.split
    if line is not None and line.size > 1:
        _STATE.split = ModelSplit(line.size, line.rank, line)
    elif line is None and size is not None and size > 1:
        _STATE.split = ModelSplit(size, rank)
    else:
        _STATE.split = None
    try:
        yield
    finally:
        _STATE.split = prev


def current() -> Optional[ModelSplit]:
    """The model split in force, or None."""
    return _STATE.split


def share(n_local: int, n_full: int, what: str) -> Optional[int]:
    """The first index of this rank's share of a dim of ``n_full``
    (``what``: "heads", "kv_heads", "mlp", "experts", "vocab",
    "ssm_heads") of which a leaf's block holds ``n_local``, or None when
    it holds it whole (the module then computes alike on every rank of
    the line).  Noted for `recording`."""
    first = None
    if n_local != n_full:
        s = current()
        if s is None or n_local * s.size != n_full:
            raise ValueError(f"a block of {n_local} of {n_full} {what} "
                             f"outside a model split of that many ranks "
                             f"({s})")
        first = s.rank * n_local
    for seen in _RECORDING:
        seen.setdefault(what, set()).add((n_local, n_full, first))
    return first


_RECORDING: list = []


@contextmanager
def recording():
    """{what: {(the rank's share, the whole, its first index or None)}}
    of every `share` asked in its scope: the heads, mlp columns, experts,
    vocab rows and SSM heads this rank computed."""
    seen: dict = {}
    _RECORDING.append(seen)
    try:
        yield seen
    finally:
        _RECORDING.remove(seen)


_TALLIES: list = []


@contextmanager
def tallying():
    """``{"all_sum": count, "bytes": the tensors summed}``: the model
    line's all_sums issued in its scope, a shape-only split's too (what
    `layout.step_plan` reads off a shape-only step)."""
    seen = {"all_sum": 0, "bytes": 0}
    _TALLIES.append(seen)
    try:
        yield seen
    finally:
        _TALLIES.remove(seen)


def _tally(t: torch.Tensor) -> None:
    for seen in _TALLIES:
        seen["all_sum"] += 1
        seen["bytes"] += t.numel() * t.element_size()


def _sum(line, t: torch.Tensor) -> torch.Tensor:
    """One all_sum over the model line (a copy: a tensor handed to a
    backward, or saved, may be shared); shape only without a line."""
    _tally(t)
    if line is None:
        core_mesh.tally("all_sum", t)
        return t.clone()
    return core_mesh.all_sum(line, t.contiguous().clone())


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, line):
        ctx.line = line
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if ctx.line is None:
            _tally(g)
            return g, None
        return _sum(ctx.line, g), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, line):
        out = _sum(line, t)
        # saved, though the backward reads nothing: a checkpoint's
        # recomputation stops once it has remade every tensor saved in its
        # region, and must run this all_sum too, on every rank alike
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, line):
        ctx.line = line
        out = _sum(line, t)
        # saved for a checkpoint's recomputation, as in `_FromModel`
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _sum(ctx.line, g), None


def to_model(t: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: ``t`` itself forward; its
    gradient summed over the model line (one all_sum) backward."""
    s = current()
    if s is None:
        return t
    return _ToModel.apply(t, s.line)


def from_model(t: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: the ranks' partial ``t``
    summed over the model line (one all_sum, the same bits on every
    rank) forward; the identity backward."""
    s = current()
    if s is None:
        return t
    return _FromModel.apply(t, s.line)


def sum_model(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` summed over the model line, forward (one
    all_sum, the same bits on every rank) and backward (one all_sum of
    the ranks' gradients: each rank's ``t`` feeds every rank's sum);
    ``t`` itself with no split."""
    s = current()
    if s is None:
        return t
    return _SumModel.apply(t, s.line)


def each(t: torch.Tensor) -> torch.Tensor:
    """(ranks, *t.shape): every rank's ``t`` of the model line in rank
    order, the same bits on every rank (`split.stacked`: one all_sum of a
    zero-padded stack; no gradient); ``t[None]`` with no split."""
    s = current()
    if s is None:
        return t.detach()[None]
    out = split.stacked(t, s.size, s.rank, s.line)
    _tally(out)
    return out


def ssm_splits(cfg, msize: int) -> bool:
    """Whether the split step computes an SSM block of ``cfg`` by its heads
    on a model line of ``msize`` ranks: the SSM heads divide the line (so
    the rules' blocks of ``out_proj`` and of the state cache are the
    rank's heads).  Every rank reads the whole B / C: one group
    (``ssm_groups`` 1, as in every config) is required."""
    if msize <= 1 or not cfg.ssm_state or cfg.nh_ssm % msize:
        return False
    if cfg.ssm_groups != 1:
        raise ValueError(f"the SSM heads split on the model line with "
                         f"ssm_groups=1 only, not {cfg.ssm_groups}")
    return True


def leaf_modes(shardings: Dict[str, object], cfg) -> Dict[str, str]:
    """{parameter name: `SPLIT` | `PARTIAL` | `FULL`} for the parameters of
    a model of ``cfg`` laid out by ``shardings`` (by name): `SPLIT` where
    the spec carries "model" (`layout.carries_model`) and the step
    computes the leaf on its model block (`rules.MODEL_PARALLEL`);
    `PARTIAL` for an attention's k / v projection and bias left whole
    while its ``wq`` splits; an SSM module's leaves by `ssm_splits` (see
    the module docstring: ``out_proj`` `SPLIT`, the rest `PARTIAL`, or
    all `FULL`); else `FULL`."""
    from repro_torch.sharding import layout
    from repro_torch.sharding.rules import MODEL_PARALLEL
    out = {}
    for name, sh in shardings.items():
        prefix, _, leaf = name.rpartition(".")
        if prefix.rpartition(".")[2] == "ssm":       # a `models.ssm.SSM`
            rows = shardings[f"{prefix}.out_proj"]
            msize = (rows.mesh.shape.get("model", 1)
                     if rows.mesh is not None else 1)
            split = ssm_splits(cfg, msize) and layout.carries_model(rows)
            out[name] = (FULL if not split else
                         SPLIT if leaf in MODEL_PARALLEL else PARTIAL)
            continue
        out[name] = (SPLIT if leaf in MODEL_PARALLEL
                     and layout.carries_model(sh) else FULL)
    for name in shardings:
        prefix, _, leaf = name.rpartition(".")
        wq = f"{prefix}.wq" if prefix else "wq"
        if (leaf in ("wk", "wv", "bk", "bv") and out[name] == FULL
                and out.get(wq) == SPLIT):
            out[name] = PARTIAL
    return out
