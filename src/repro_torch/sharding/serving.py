"""Prefill and decode on a grid: what GSPMD does to the JAX package's
``jax.jit(M.prefill / M.decode_step, in_shardings=..., out_shardings=(None,
cache shardings))`` on a mesh (`repro.launch.dryrun`), for a port whose
ranks are processes.  GSPMD computes this in JAX, so the module has no
JAX counterpart.

`mesh_prefill` and `mesh_decode` take the shardings as
`layout.mesh_step` does (``{"params": ..., "caches": ...}`` by the rules:
`rules.param_shardings`, `rules.cache_shardings` over
`models.cache_specs`) and the batch's (`rules.batch_spec`), and run the
one-rank model code (`models.prefill`, `models.decode_step`) on this
rank's share, forward only:

- **its batch rows** (`layout.batch_rows`, which raises where the batch
  does not split), inside the data split of its data line
  (`sharding.split`: MoE's prefill capacity comes from the global token
  count; decode, one token a row, drops nothing);
- **its parameters** gathered one unit at a time (`sharding.fsdp`), with
  no gradient and so no reduction;
- **its model share** (`sharding.tensor`): heads, mlp columns, experts,
  vocab rows and SSM heads as the split training step computes them; the
  vocab-parallel logits' blocks, and the rows of the other data ranks,
  are gathered by one all_sum of a zero-padded stack, so every rank
  returns the whole last-token logits (JAX's ``out_shardings=None``);
- **its caches** in the blocks that `rules.cache_shardings` gives: prefill
  returns the rank's blocks, decode writes into them in place and returns
  them.  No rank holds a whole cache.

The rules lay a KV cache (B, S, kv heads, head_dim) out in one of three
ways, and the model code reads this rank's cut of it (`current`):

- (a) the kv heads divide the model line: the rank projects its kv heads
  and its block holds them; attention needs nothing more;
- (b) they do not, and head_dim does: the block holds a head_dim block of
  every kv head.  Decode writes the rank's head_dim block of the new
  k / v; every rank gets every q head (one all_sum of a zero-padded
  stack, where the q heads split), sums the scores of its head_dim block
  over the model line (one all_sum of (B, H, 1, S)), takes the softmax
  alike, and gathers p.v of its head_dim block (one all_sum of a
  zero-padded stack of (B, H, head_dim)); its own heads then go through
  its ``wo`` block, as in training.  Prefill projects k / v whole and
  keeps the head_dim block;
- (c) the batch does not divide the data axes (long_500k's batch of 1;
  `hints.configure(kv_masked_write=True)`): every data rank holds the
  whole batch and a block of S.  Decode's masked write lands only on the
  rank that owns the position, at its local offset, and attention is a
  split-softmax combine over the line that splits S: each rank's (max,
  sum of exponentials, weighted values) on its positions, exchanged by
  one all_sum of a zero-padded stack and combined in rank order, the same
  bits on every rank.  Prefill computes the whole batch on every data
  rank and keeps its block of S.

The SSM caches, conv (B, W - 1, convdim) and state (B, nh, hp, st), are
split on "model" by the rules: the conv by contiguous blocks of its
channels, the state by its heads.  Where the SSM heads divide the model
line (`tensor.ssm_splits`) the layer computes the rank's heads, whose
state is the rank's block: prefill keeps the final state of its heads,
decode updates its block in place, and the state is never exchanged.
The conv's blocks do not line up with a rank's heads: decode gathers
them over the model line (one all_sum of a zero-padded stack a layer,
`conv_whole`) for the history of its channels, and writes its block
from the new [x | B | C] columns of that block; prefill keeps its block
of the last W - 1 tokens, with no exchange.  Where the heads do not
divide the line the layer runs whole on every rank, and the rules leave
the state whole too.

On one rank the entry points are `models.prefill` / `models.decode_step`
themselves.  On a shape-only mesh (no process group: the dry run and
`layout.serve_plan` on meta tensors) the splits are shape only, and every
exchange is `core_mesh.tally`'d, not issued.
"""
from __future__ import annotations

import contextlib
import math
import types
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import mesh as core_mesh
from repro_torch.sharding import fsdp, split

__all__ = ["Cut", "CacheSplit", "current", "cache_split", "cuts",
           "mesh_prefill", "mesh_decode", "kv_block", "conv_block",
           "state_block", "conv_whole", "exchange"]

_STATE = types.SimpleNamespace(split=None)


@dataclass(frozen=True)
class Cut:
    """One dim of a cache leaf split over the line of ``axes``: ``size``
    blocks, this rank's being ``index``; ``line`` is the line's
    `core.mesh.Mesh` (None: shape only)."""
    axes: Tuple[str, ...]
    size: int
    index: int
    line: Optional[core_mesh.Mesh] = None

    def block(self, n: int) -> slice:
        """This rank's block of a dim of ``n``."""
        if n % self.size:
            raise ValueError(f"a cache dim of {n} does not split "
                             f"{self.size} ways over {self.axes}")
        m = n // self.size
        return slice(self.index * m, (self.index + 1) * m)


@dataclass(frozen=True)
class CacheSplit:
    """This rank's cut of the serving caches: the KV caches' S dim
    (``seq``) and head_dim (``hd``), the SSM conv's channels (``conv``)
    and the SSM state's heads (``nh``); None where the dim is whole."""
    seq: Optional[Cut] = None
    hd: Optional[Cut] = None
    conv: Optional[Cut] = None
    nh: Optional[Cut] = None


def current() -> Optional[CacheSplit]:
    """The cache split in force, or None."""
    return _STATE.split


@contextlib.contextmanager
def cache_split(c: Optional[CacheSplit]):
    """The model code inside reads and writes ``c``'s blocks of its
    caches."""
    prev = _STATE.split
    _STATE.split = c
    try:
        yield
    finally:
        _STATE.split = prev


def _cut(entry, mesh) -> Optional[Cut]:
    axes = () if entry is None else tuple(
        a for a in (entry if isinstance(entry, tuple) else (entry,))
        if mesh.shape[a] > 1)
    if not axes:
        return None
    coords = mesh.coords or {a: 0 for a in mesh.axis_names}
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + coords[a]
    line = mesh.line(axes)[0] if mesh.world is not None else None
    return Cut(axes, math.prod(mesh.shape[a] for a in axes), index, line)


def cuts(cache_shardings) -> CacheSplit:
    """This rank's `CacheSplit` of a tree of cache shardings
    (`rules.cache_shardings` over `models.cache_specs`, as `Sharding`s):
    each kind of leaf the same spec on its trailing dims, or a raise."""
    from repro_torch.sharding import layout
    found = {}
    for path, sh in layout.flat(cache_shardings).items():
        kind = ("kv" if {"k", "v"} & set(path) else
                "conv" if "conv" in path else
                "ssm" if "ssm" in path else None)
        if kind is None:
            raise ValueError(f"unknown cache leaf {path}")
        tail = tuple(sh.spec)[-(3 if kind == "conv" else 4):]
        if found.setdefault(kind, (tail, sh.mesh))[0] != tail:
            raise ValueError(f"cache leaves of one kind laid out apart: "
                             f"{tail} and {found[kind][0]}")
    kw = {}
    if "kv" in found:
        (_, s, _, hd), mesh = found["kv"]
        kw.update(seq=_cut(s, mesh), hd=_cut(hd, mesh))
    if "conv" in found:
        (_, _, c), mesh = found["conv"]
        kw["conv"] = _cut(c, mesh)
    if "ssm" in found:
        (_, nh, _, _), mesh = found["ssm"]
        kw["nh"] = _cut(nh, mesh)
    return CacheSplit(**kw)


def exchange(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """(cut.size, *t.shape): every rank's ``t`` of ``cut``'s line in
    block order, the same bits on every rank (`split.stacked`: one all_sum
    of a zero-padded stack)."""
    return split.stacked(t, cut.size, cut.index, cut.line)


# ---------------------------------------------------------------------------
# the model code's cuts
# ---------------------------------------------------------------------------

def kv_block(t: torch.Tensor) -> torch.Tensor:
    """A prefill's k or v (B, S, kv heads, head_dim), padded to the cache's
    S, as this rank keeps it: its block of S and of head_dim (its kv heads
    are the ones it projected)."""
    c = current()
    if c is None:
        return t
    if c.seq is not None:
        t = t[:, c.seq.block(t.shape[1])]
    if c.hd is not None:
        t = t[..., c.hd.block(t.shape[3])]
    return t


def conv_block(n: int) -> slice:
    """This rank's block of an SSM conv cache's ``n`` channels (all of
    them where the rules leave the channels whole)."""
    c = current()
    if c is None or c.conv is None:
        return slice(0, n)
    return c.conv.block(n)


def state_block(nh: int) -> slice:
    """This rank's block of an SSM state cache's ``nh`` heads (all of them
    where the rules leave the heads whole)."""
    c = current()
    if c is None or c.nh is None:
        return slice(0, nh)
    return c.nh.block(nh)


def conv_whole(conv: torch.Tensor) -> torch.Tensor:
    """The whole conv cache (B, W - 1, convdim) of this rank's rows from
    its block: one exchange of the blocks over the model line where the
    rules split the channels (``conv`` itself where they do not)."""
    c = current()
    if c is None or c.conv is None:
        return conv
    return torch.cat(exchange(conv, c.conv).unbind(0), dim=-1)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _whole_logits(logits: torch.Tensor, mesh, batch_shardings, vocab: int):
    """The whole (B, 1, V) logits on every rank from this rank's rows and
    vocab columns: one all_sum of a zero-padded stack over the line of the
    axes that split them (rows on the data axes, vocab on "model")."""
    from repro_torch.sharding import layout
    rows = layout.data_axes(batch_shardings)
    cols = ("model",) if logits.shape[-1] != vocab else ()
    axes = tuple(a for a in mesh.axis_names if a in rows + cols)
    if not axes:
        return logits
    d = math.prod(mesh.shape[a] for a in rows)
    m = mesh.shape["model"] if cols else 1
    cut = _cut(axes, mesh)
    b, t, v = logits.shape
    stack = exchange(logits, cut).reshape(d, m, b, t, v)
    return stack.permute(0, 2, 3, 1, 4).reshape(d * b, t, m * v)


@contextlib.contextmanager
def _scope(model, shardings, batch_shardings):
    """The forward-only scopes of a serving call on this rank."""
    from repro_torch.sharding import layout
    with torch.no_grad(), layout.mesh_scope(
            model, shardings["params"], batch_shardings, reduce=False), \
            cache_split(cuts(shardings["caches"])), \
            fsdp.gathered(model):
        yield


def mesh_prefill(shardings, batch_shardings):
    """``prefill(params, batch, max_len) -> (logits, caches)`` on a mesh
    (see the module docstring): ``params`` this rank's blocks by
    ``shardings["params"]``, ``batch`` the global batch; the whole
    last-token logits and this rank's blocks of the caches at
    ``max_len`` by ``shardings["caches"]``.  On one rank,
    `models.prefill` itself."""
    from repro_torch.models import model as M
    from repro_torch.sharding import layout
    mesh = layout.mesh_of(shardings["params"])

    def prefill(params, batch, max_len: int):
        if mesh.size == 1:
            return M.prefill(params, batch, max_len)
        rows = layout.batch_rows(batch, batch_shardings)
        with _scope(params, shardings, batch_shardings):
            logits, caches = M.prefill(params, rows, max_len)
            logits = _whole_logits(logits, mesh, batch_shardings,
                                   params.cfg.vocab)
        return logits, caches
    return prefill


def mesh_decode(shardings, batch_shardings):
    """``decode(params, tokens, caches, pos, batch_extras=None) ->
    (logits, caches)`` on a mesh (see the module docstring): ``tokens``
    the global (B, 1) tokens (and ``batch_extras`` the global extras),
    ``caches`` this rank's blocks, written in place and returned, with
    the whole logits.  On one rank, `models.decode_step` itself."""
    from repro_torch.models import model as M
    from repro_torch.sharding import layout
    mesh = layout.mesh_of(shardings["params"])

    def decode(params, tokens, caches, pos, batch_extras=None):
        if mesh.size == 1:
            return M.decode_step(params, tokens, caches, pos, batch_extras)
        rows = layout.batch_rows(dict(batch_extras or {}, tokens=tokens),
                                 batch_shardings)
        tokens = rows.pop("tokens")
        with _scope(params, shardings, batch_shardings):
            logits, caches = M.decode_step(params, tokens, caches, pos,
                                           rows or None)
            logits = _whole_logits(logits, mesh, batch_shardings,
                                   params.cfg.vocab)
        return logits, caches
    return decode
