"""A state laid out on a mesh by the sharding rules -- the port's
counterpart of what ``jax.jit(in_shardings=..., out_shardings=...)`` does
to the train state.

`shard` keeps this rank's block of every leaf (a `rules.Sharding` says
how each dim splits over the mesh axes; a spec entry of several axes
splits its dim row-major over them); `gather` rebuilds whole tensors.
A block owned by another rank arrives by one `core.mesh.broadcast` from
its owner over the line of ranks that hold the tensor's other blocks
(`launch.mesh.GridMesh.line`): the bytes of an all_gather along those
axes, through the one collective that NCCL, gloo on the CPU and gloo
ranks sharing a card all take.  `collective_plan` counts what a gather
moves; the mesh step and the dry run read it.

**The step on a mesh** (`mesh_step`): gather the state and the global
batch, run the unchanged single-device step on them, keep this rank's
blocks.  Every rank computes the global program, so the result is one
device's (the logdet aux's covariance and MoE routing see the whole
batch, as under GSPMD); between steps each rank holds its blocks alone.
The arithmetic is not split across ranks.  A step commits on every rank
or on none: the ranks `agree` (one all_sum) on whether any of them
raised, and if one did, every rank raises with its blocks as they were.
A fault inside a gather itself (a lost rank, a broken transport) is not
recovered: the other ranks wait in their collective.

A sharded state is the state's own tree holding blocks: the model's
parameters are swapped to their blocks in place (``p.data``), the
optimizer tree and the step are new trees.  A one-rank mesh (or a spec
whose axes have size 1) shards nothing and issues no collective.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core import mesh as core_mesh
from repro_torch.sharding.rules import PartitionSpec, Sharding, tree_map

__all__ = ["shard_shape", "whole_shape", "whole_like", "block_slices", "local_block", "gather_leaf",
           "shard", "gather", "mesh_step", "collective_plan", "step_plan",
           "flat", "mesh_of", "agree", "barrier", "resident_bytes"]


def _entries(spec, mesh) -> List[Tuple[int, Tuple[str, ...]]]:
    """(dim, the axes of more than one rank it splits over) per sharded
    dim of a spec."""
    out = []
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = tuple(a for a in (e if isinstance(e, tuple) else (e,))
                     if mesh.shape[a] > 1)
        if axes:
            out.append((d, axes))
    return out


def _count(axes, mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def shard_shape(shape, sharding: Sharding) -> Tuple[int, ...]:
    """The block shape of a whole ``shape`` under ``sharding``."""
    out = list(shape)
    for d, axes in _entries(sharding.spec, sharding.mesh):
        n = _count(axes, sharding.mesh)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways ({sharding.spec})")
        out[d] //= n
    return tuple(out)


def whole_shape(shape, sharding: Sharding) -> Tuple[int, ...]:
    """The whole shape of a block's ``shape`` under ``sharding`` (the
    inverse of `shard_shape`)."""
    out = list(shape)
    for d, axes in _entries(sharding.spec, sharding.mesh):
        out[d] *= _count(axes, sharding.mesh)
    return tuple(out)


def whole_like(tree, shardings):
    """Meta tensors of the whole shapes of a tree of blocks (for
    `collective_plan` without a gather)."""
    sh = flat(shardings)
    return tree_map(lambda path, t: torch.empty(
        whole_shape(t.shape, sh[path]), dtype=t.dtype, device="meta"), tree)


def _block_of(axes, coords, mesh) -> int:
    """The block index of ``coords`` along ``axes`` (row-major)."""
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def block_slices(shape, sharding: Sharding, coords=None) -> tuple:
    """The slices of the block at ``coords`` (default: this rank's)."""
    mesh = sharding.mesh
    coords = mesh.coords if coords is None else coords
    block = shard_shape(shape, sharding)
    out = [slice(None)] * len(shape)
    for d, axes in _entries(sharding.spec, mesh):
        i = _block_of(axes, coords, mesh)
        out[d] = slice(i * block[d], (i + 1) * block[d])
    return tuple(out)


def local_block(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of a whole tensor: ``t`` itself when nothing
    splits, else a contiguous copy (a view would keep the whole tensor
    resident)."""
    if not _entries(sharding.spec, sharding.mesh):
        return t
    return t[block_slices(t.shape, sharding)].clone()


def gather_leaf(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The whole tensor of this rank's block ``t``: one broadcast per
    block from its owner over the line of ranks along the sharded axes
    (``t`` itself when nothing splits).  Every rank of the line calls
    it, in the same order of leaves."""
    mesh = sharding.mesh
    entries = _entries(sharding.spec, mesh)
    if not entries:
        return t
    shape = whole_shape(t.shape, sharding)
    axes_all = [a for _, axes in entries for a in axes]
    line, ranks = mesh.line(axes_all)
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    mine = t.contiguous()
    bufs, works = [], []
    for combo in itertools.product(*(range(mesh.shape[a])
                                     for a in axes_all)):
        coords = dict(mesh.coords)
        coords.update(zip(axes_all, combo))
        owner = ranks.index(mesh.rank_of(coords))
        buf = mine if owner == line.rank else torch.empty_like(mine)
        works.append(core_mesh.broadcast(line, buf, owner, async_op=True))
        bufs.append((coords, buf))
    for w in works:
        w.wait()
    for coords, buf in bufs:
        out[block_slices(shape, sharding, coords)] = buf
    return out


def _leafwise(fn, state, shardings):
    """``fn(tensor, sharding)`` over a state and its matching shardings
    tree; a model's parameters are swapped in place (``p.data``)."""
    if isinstance(state, torch.nn.Module):
        for name, p in state.named_parameters():
            p.data = fn(p.data, shardings[name])
        return state
    if isinstance(state, dict):
        return {k: _leafwise(fn, v, shardings[k]) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_leafwise(fn, v, s)
                           for v, s in zip(state, shardings))
    if state is None:
        return None
    return fn(state, shardings)


def shard(state, shardings):
    """This rank's blocks of a state of whole tensors (no collective)."""
    return _leafwise(local_block, state, shardings)


def gather(state, shardings):
    """The whole tensors of a sharded state (see `gather_leaf`)."""
    return _leafwise(gather_leaf, state, shardings)


def _splits(sharding: Sharding) -> bool:
    return bool(_entries(sharding.spec, sharding.mesh))


def mesh_step(train_step, shardings, batch_shardings):
    """``step(state, batch)`` on a mesh: ``state`` sharded by
    ``shardings``, ``batch`` this rank's block by ``batch_shardings``.
    Gathers both, runs ``train_step`` on the whole state and batch, and
    returns (the new state's blocks, the metrics).  If ``train_step``
    raises on any rank, every rank raises and keeps its blocks as they
    were (``train_step`` may update the whole state in place: a leaf that
    no rank splits is copied before it, on a mesh of more than one
    rank)."""
    mesh = mesh_of(shardings)

    def step(state, batch):
        # a model's parameters are swapped in place: hold their blocks
        params = [p for p in flat(state).values()
                  if isinstance(p, torch.nn.Parameter)]
        held = [p.data for p in params]
        whole = gather(state, shardings)
        if mesh.size > 1:
            whole = _leafwise(lambda t, s: t if _splits(s) else t.clone(),
                              whole, shardings)
        err = None
        try:
            whole, metrics = train_step(whole, gather(batch, batch_shardings))
            new = shard(whole, shardings)
        except Exception as e:          # noqa: BLE001 -- agreed below
            err = e
        if agree(mesh, err is not None):
            for p, block in zip(params, held):
                p.data = block
            raise err if err is not None else RuntimeError(
                "the step failed on another rank of the mesh")
        return new, metrics
    return step


def flat(tree, path=()) -> Dict[tuple, object]:
    """A tree of shardings, specs or tensors (a model contributes its
    named parameters) as {path: leaf}; dict keys and parameter names split
    at dots, so a model's ``blocks.3.attn.wq`` is the path a checkpoint
    names (``("blocks", "3", "attn", "wq")``)."""
    if isinstance(tree, torch.nn.Module):
        return {path + tuple(k.split(".")): p
                for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + tuple(str(k).split("."))))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
        return out
    return {} if tree is None else {path: tree}


def mesh_of(shardings):
    """The mesh of a shardings tree."""
    return next(iter(flat(shardings).values())).mesh


def agree(mesh, failed: bool) -> bool:
    """Whether ``failed`` holds on any rank of ``mesh`` (a `GridMesh`):
    one all_sum of one element over the whole grid, which every rank
    calls; on one rank, ``failed`` itself."""
    if mesh.size == 1:
        return failed
    line, _ = mesh.line(mesh.axis_names)
    flag = torch.full((1,), float(failed), dtype=torch.float32,
                      device=mesh.device)
    return bool(core_mesh.all_sum(line, flag).item() > 0)


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits until every other reaches this call
    (so what rank 0 wrote before it is there): `agree` on nothing."""
    agree(mesh, False)


def collective_plan(shardings, shapes) -> Dict[str, float]:
    """What gathering a tree costs each rank: ``{"broadcast": count,
    "bytes": wire bytes}`` (a broadcast moves its block, so a split leaf
    costs its whole bytes).  ``shapes`` is the matching tree of whole
    tensors (any device, ``meta`` included)."""
    count, nbytes = 0, 0
    sh = flat(shardings)
    for path, t in flat(tree_map(lambda p, x: x, shapes)).items():
        s = sh[path]
        n = math.prod(_count(axes, s.mesh)
                      for _, axes in _entries(s.spec, s.mesh))
        if n > 1:
            count += n
            nbytes += t.numel() * t.element_size()
    return {"broadcast": count, "bytes": nbytes}


def step_plan(shardings, shapes) -> Dict[str, float]:
    """What one `mesh_step` costs each rank: `collective_plan` of its
    state and batch (``shardings`` and ``shapes`` trees holding both), and
    the all_sum that agrees on a fault (none on one rank)."""
    plan = collective_plan(shardings, shapes)
    plan["all_sum"] = int(mesh_of(shardings).size > 1)
    return plan


def resident_bytes(shardings, shapes) -> int:
    """The bytes of one rank's blocks of a tree of whole tensors."""
    sh = flat(shardings)
    total = 0
    for path, t in flat(tree_map(lambda p, x: x, shapes)).items():
        total += math.prod(shard_shape(t.shape, sh[path])) * t.element_size()
    return total
