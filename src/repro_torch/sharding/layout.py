"""A state laid out on a mesh by the sharding rules -- the port's
counterpart of what ``jax.jit(in_shardings=..., out_shardings=...)`` does
to the train state -- and the training step on it.

`shard` keeps this rank's block of every leaf (a `rules.Sharding` says
how each dim splits over the mesh axes; a spec entry of several axes
splits its dim row-major over them); `gather` rebuilds whole tensors.
A block owned by another rank arrives by one `core.mesh.broadcast` from
its owner over the line of ranks that hold the tensor's other blocks
(`launch.mesh.GridMesh.line`): the bytes of an all_gather along those
axes, through the one collective that NCCL, gloo on the CPU and gloo
ranks sharing a card all take.  `collective_plan` counts what a gather
moves.

**The step on a mesh** (`mesh_step`) splits the arithmetic over the data
axes and over "model", in the order the JAX rules apply them:

- each rank holds its rows of every global microbatch (`batch_rows`; a
  batch that does not divide the data axes is whole on every rank), and
  the ranks of one "model" line hold the same rows;
- the parameters are gathered one unit at a time (`sharding.fsdp`: a
  block module of the stack just before it runs, again for its backward,
  and dropped after; the embedding, the final norm and the head once a
  microbatch), so no rank holds the whole model at once; a leaf the
  rules split on "model" and the step computes model-parallel is
  gathered over the data line only, and the rank keeps its model block
  (`carries_model`, `model_block`, `tensor.leaf_modes`);
- the loss runs inside a data split (`sharding.split`) over the rank's
  data line: the statistics of the whole batch (the CE's token count,
  the logdet aux's covariance, MoE's capacity, slots and balance) are
  reduced over the line, and each unit's gradient is summed over it in
  the unit's backward, by one all_sum a tensor (the same bits on every
  rank), of which the rank keeps its block;
- and inside a model split (`sharding.tensor`) over the rank's model
  line: the rank computes its q heads (its kv heads where they divide),
  its mlp columns, its experts and its vocab rows, and the partial sums
  go over the model line (column-parallel in, row-parallel out); a
  module whose leaves the rules leave whole there (MoE's router, the SSM
  blocks) is computed alike on every rank of the line;
- the clip takes the global norm from the blocks (one all_sum over the
  whole grid of each rank's f64 sum of squares, each element counted by
  one rank), the same on every rank, and the optimizer updates this rank's
  blocks only: the optimizer state is never gathered (Adafactor, whose
  update reads the whole leaf, gets its clipped gradients gathered
  whole).

A step commits on every rank or on none: after the compute the ranks
`agree` (one all_sum over the whole process group, which no step
collective uses) on whether any of them raised, and if one did, every
rank raises with its blocks as they were; only then does the optimizer
write.  A rank that raises inside the compute leaves the other ranks of
its data line waiting in the step's next collective over it; that wait
ends at the grid's collective timeout (`launch.mesh.GridMesh`) with a
raise, so they too reach `agree`, and every rank remakes its line
groups before raising.  A rank that is lost, or a transport that
breaks, is not recovered: the others wait in `agree`.  `step_plan`
counts one step's collectives.

A sharded state is the state's own tree holding blocks: the model's
parameters are swapped to their blocks in place (``p.data``), the
optimizer tree and the step are new trees.  A one-rank mesh (or a spec
whose axes have size 1) shards nothing and issues no collective, and its
step is bitwise the single-device step.  On a shape-only mesh (no
process group behind it: the dry run on meta tensors) `gather` fills
every block with this rank's, the split is shape only, and nothing is
exchanged.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core import mesh as core_mesh
from repro_torch.optim.optimizers import (clip_by_global_norm, get_optimizer,
                                          jax_ndim)
from repro_torch.sharding import fsdp, split, tensor
from repro_torch.sharding.rules import (PartitionSpec, Sharding,
                                        param_shardings, tree_map)

__all__ = ["shard_shape", "whole_shape", "whole_like", "block_slices",
           "carries_model", "model_block",
           "local_block", "gather_leaf", "gather_leaves", "shard", "gather",
           "state_shardings", "data_axes", "batch_rows", "mesh_grad_fn",
           "global_norm", "WHOLE_LEAF", "mesh_step", "collective_plan",
           "step_plan", "flat", "mesh_of",
           "agree", "barrier", "resident_bytes"]


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


def carries_model(sharding: Sharding) -> bool:
    """Whether ``sharding``'s spec splits a dim over "model" (of more than
    one rank)."""
    return any("model" in axes
               for _, axes in _entries(sharding.spec, sharding.mesh))


def model_block(sharding: Sharding) -> Sharding:
    """The layout of a rank's block inside its model block: ``sharding``
    without "model" (gathering by it rebuilds the model block)."""
    spec = []
    for e in sharding.spec:
        axes = () if e is None else tuple(
            a for a in (e if isinstance(e, tuple) else (e,)) if a != "model")
        spec.append(axes or None)
    return Sharding(sharding.mesh, PartitionSpec(*spec))


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
    it, in the same order of leaves.  On a shape-only mesh every block
    is ``t`` (one tiling, no collective)."""
    return gather_leaves([t], [sharding])[0]


def gather_leaves(ts, shardings) -> List[torch.Tensor]:
    """`gather_leaf` of each block of ``ts`` (laid out by the matching
    ``shardings``), every broadcast issued before the first is waited on:
    the same broadcasts, in the same order, with the line's latency
    overlapped."""
    outs, fills, works = [], [], []
    for t, sharding in zip(ts, shardings):
        mesh = sharding.mesh
        entries = _entries(sharding.spec, mesh)
        if not entries:
            outs.append(t)
            continue
        shape = whole_shape(t.shape, sharding)
        if mesh.world is None:
            outs.append(t.repeat(tuple(w // b for w, b in zip(shape,
                                                              t.shape))))
            continue
        axes_all = [a for _, axes in entries for a in axes]
        line, ranks = mesh.line(axes_all)
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        mine = t.contiguous()
        for combo in itertools.product(*(range(mesh.shape[a])
                                         for a in axes_all)):
            coords = dict(mesh.coords)
            coords.update(zip(axes_all, combo))
            owner = ranks.index(mesh.rank_of(coords))
            buf = mine if owner == line.rank else torch.empty_like(mine)
            works.append(core_mesh.broadcast(line, buf, owner,
                                             async_op=True))
            fills.append((out, block_slices(shape, sharding, coords), buf))
        outs.append(out)
    for w in works:
        w.wait()
    for out, where, buf in fills:
        out[where] = buf
    return outs


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


def state_shardings(state, cfg, mesh, optimizer: str):
    """The shardings of a train state (``{"params", "opt", "step"}``) on
    ``mesh`` for `mesh_step`: the parameters and AdamW's moments by the
    JAX rules; Adafactor's moments whole on every rank, as its update
    reads the whole leaf (rows plus columns of each; `optim`); the step
    whole."""
    whole = Sharding(mesh, PartitionSpec())
    opt = param_shardings(state["opt"], cfg, mesh)
    if optimizer == "adafactor":
        opt = tree_map(lambda _, s: whole, opt)
    return {"params": param_shardings(state["params"], cfg, mesh),
            "opt": opt, "step": whole}


def data_axes(batch_shardings) -> Tuple[str, ...]:
    """The mesh axes (of more than one rank) that split the batch's rows:
    the data axes, or none when the batch is whole on every rank."""
    s = batch_shardings["tokens"]
    ent = _entries(s.spec, s.mesh)
    return ent[0][1] if ent and ent[0][0] == 0 else ()


def batch_rows(batch, batch_shardings, microbatches: int = 1):
    """This rank's rows of a global batch: its share of every global
    microbatch (microbatch i is global rows [i b/mb, (i+1) b/mb), split
    over the data axes in rank order), the microbatches in order.  With
    one microbatch that is the rules' block (`local_block`); a leaf that
    the rules do not split is whole."""
    out = {}
    for k, x in batch.items():
        s = batch_shardings[k]
        ent = _entries(s.spec, s.mesh)
        if not ent:
            out[k] = x
            continue
        (dim, axes), = ent
        n, b = _count(axes, s.mesh), x.shape[0]
        if dim != 0 or b % (microbatches * n):
            raise ValueError(f"{k}: a batch of {b} rows does not split into "
                             f"{microbatches} microbatches over {n} ranks")
        i = _block_of(axes, s.mesh.coords, s.mesh)
        out[k] = x.reshape(microbatches, n, b // (microbatches * n),
                           *x.shape[1:])[:, i].reshape(
            b // n, *x.shape[1:]).contiguous()
    return out


def mesh_grad_fn(grad_fn, shardings, batch_shardings):
    """``grads(state, batch) -> (grads, metrics)`` on a mesh: ``state``
    sharded by ``shardings``, ``batch`` this rank's rows (`batch_rows`).
    Runs ``grad_fn`` (`train.step.make_grad_fn`) with the parameters
    gathered one unit at a time (`fsdp.sharded`) inside the data split of
    the batch's data line and the model split of the rank's model line:
    this rank's blocks of the reduced gradients, the same bits on every
    rank that holds one, and the global batch's metrics (on a shape-only
    mesh, shape-only splits and no sum).  On one rank, ``grad_fn``
    itself."""
    axes = data_axes(batch_shardings)
    mesh = mesh_of(shardings)
    psh = shardings["params"]
    msize = mesh.shape.get("model", 1)

    def grads(state, batch):
        if mesh.size == 1:
            return grad_fn(state["params"], batch)
        line = mline = wide = None
        if mesh.world is not None:                      # lines as remade
            line = mesh.line(axes)[0] if axes else None
            if msize > 1:
                mline = mesh.line(("model",))[0]
                wide = mesh.line(tuple(axes) + ("model",))[0]
        if not axes:
            data = split.data_split()
        elif line is None:
            data = split.data_split(size=_count(axes, mesh))
        else:
            data = split.data_split(line)
        if mline is not None:
            model = tensor.model_split(mline)
        else:
            model = tensor.model_split(
                size=msize, rank=(mesh.coords or {}).get("model", 0))
        with data, model, fsdp.sharded(state["params"], psh, line, wide):
            return grad_fn(state["params"], batch)
    return grads


def _owned(sharding: Sharding) -> bool:
    """Whether this rank is the one that counts its block of a leaf laid
    out by ``sharding`` once: its coordinate is 0 on every axis that does
    not split the leaf."""
    mesh = sharding.mesh
    split_axes = {a for _, axes in _entries(sharding.spec, mesh)
                  for a in axes}
    return all(c == 0 for a, c in mesh.coords.items() if a not in split_axes)


def global_norm(grads, shardings, mesh) -> torch.Tensor:
    """The global norm (f32) of gradients laid out as the parameters
    (``shardings`` by name): each rank's sum of squares over the blocks
    it counts (`_owned`), summed by one all_sum over the whole grid
    (every rank gets the same bits; on a shape-only mesh, this rank's).
    The sums are f64, where an f32 square is exact and the order of the
    additions is lost in the cast back to f32: so the norm's bits do not
    depend on how the grid cuts the leaves (a 2x1 grid steps bitwise as
    a 2x2 one)."""
    dev = next(iter(grads.values())).device
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for n, g in grads.items():
        if _owned(shardings[n]):
            sq = sq + torch.sum(torch.square(g.to(torch.float64)))
    if mesh.world is not None:
        sq = core_mesh.all_sum(mesh.line(mesh.axis_names)[0],
                               sq.reshape(1)).reshape(())
    return torch.sqrt(sq.to(torch.float32))


# the optimizers whose update reads the whole leaf (`optim` ``blocks=``)
WHOLE_LEAF = ("adafactor",)


def mesh_step(grad_fn, opt, shardings, batch_shardings, on_grads=None):
    """``step(state, batch) -> (state, metrics)`` on a mesh (see the
    module docstring): `mesh_grad_fn`, the clip by the blocks' global
    norm, then ``opt``'s (an `OptConfig`) update of this rank's blocks in
    place; ``metrics`` as `train.step.make_train_step`'s.
    ``on_grads(grads, metrics)``, when given, sees this rank's blocks of
    the reduced gradients before the clip.  If the compute raises on any
    rank, every rank raises and keeps its blocks as they were."""
    mesh = mesh_of(shardings)
    grads_of = mesh_grad_fn(grad_fn, shardings, batch_shardings)
    _, update = get_optimizer(opt)
    psh = shardings["params"]

    def step(state, batch):
        err = None
        try:
            grads, metrics = grads_of(state, batch)
            if on_grads is not None:
                on_grads(grads, metrics)
            norm = None if mesh.size == 1 else global_norm(grads, psh, mesh)
            grads, gnorm = clip_by_global_norm(grads, opt.clip_norm,
                                               norm=norm)
            blocks = None
            if opt.name in WHOLE_LEAF and mesh.size > 1:
                blocks = {n: block_slices(whole_shape(g.shape, psh[n]),
                                          psh[n]) for n, g in grads.items()}
                grads = {n: gather_leaf(g, psh[n]) for n, g in grads.items()}
        except Exception as e:          # noqa: BLE001 -- agreed below
            err = e
        if agree(mesh, err is not None):
            raise err if err is not None else RuntimeError(
                "the step failed on another rank of the mesh")
        # ---- the commit point: nothing above wrote the state ----
        if blocks is None:
            update(grads, state["opt"], state["params"])
        else:
            update(grads, state["opt"], state["params"], blocks=blocks)
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return state, metrics
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
    one all_sum of one element over the whole process group, which every
    rank calls; on one rank or a shape-only mesh, ``failed`` itself.  If
    it holds, every rank remakes its line groups
    (`launch.mesh.GridMesh.remake_lines`): a rank that failed may have
    left a line's collectives out of step."""
    if mesh.size == 1 or mesh.world is None:
        return failed
    flag = torch.full((1,), float(failed), dtype=torch.float32,
                      device=mesh.device)
    if core_mesh.all_sum(mesh.world, flag).item() == 0:
        return False
    mesh.remake_lines()
    return True


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


def _model_line(cfg, tcfg, shardings, batch_shardings, rows) -> Dict:
    """``{"all_sum", "bytes"}`` over the model line in one step of this
    rank, read off the step itself: `mesh_grad_fn` run shape only on
    meta tensors (a model of ``cfg`` laid out by ``shardings``' specs on
    a shape-only mesh with this rank's coordinates, on ``rows``' shapes),
    counting every all_sum that the model split would issue
    (`tensor.tallying`): the column-parallel inputs' gradients, the
    row-parallel outputs (in every recomputation too) and the exchanges
    of the vocab-parallel cross-entropy."""
    from repro_torch.launch.mesh import GridMesh
    from repro_torch.models.common import empty_init
    from repro_torch.models.model import Model
    from repro_torch.train.step import make_grad_fn
    if rows is None:
        raise ValueError("step_plan needs the rank's batch rows on a model "
                         "split")
    mesh = mesh_of(shardings)
    coords = mesh.coords or {a: 0 for a in mesh.axis_names}
    shape_only = GridMesh(mesh.axis_names, tuple(mesh.shape.values()),
                          rank=mesh.rank_of(coords))

    def on(tree):
        return tree_map(lambda _, s: Sharding(shape_only, s.spec), tree)
    meta = torch.device("meta")
    psh = on(shardings["params"])
    model = shard(Model(cfg, empty_init(meta)), psh)
    grads = mesh_grad_fn(make_grad_fn(cfg, tcfg), {"params": psh},
                         on(batch_shardings))
    with tensor.tallying() as seen:
        grads({"params": model}, {k: torch.empty(x.shape, dtype=x.dtype,
                                                 device=meta)
                                  for k, x in rows.items()})
    return seen


def step_plan(cfg, tcfg, shardings, batch_shardings, params,
              rows=None) -> Dict[str, object]:
    """What one `mesh_step` costs each rank.  ``params`` holds the whole
    parameters (a model or a dict, any device, ``meta`` included);
    ``tcfg`` is the `TrainConfig`; ``rows`` (this rank's batch rows,
    `batch_rows`, any device) are needed where the model line splits a
    leaf.

    - broadcasts, each microbatch: every unit's gathers
      (`fsdp.gather_counts`: the root once, a layer unit once a call in
      the forward and again in the backward), a leaf gathered over n
      ranks costing n broadcasts and its gathered bytes in the dtype
      gathered (bf16 where ``cast_params_bf16`` casts it): a leaf the
      step splits on "model" (`tensor.leaf_modes`) is gathered over the
      data line only, its model block's bytes; with Adafactor, once a
      step, the clipped gradients gathered whole;
    - all_sums, each microbatch: the nll metric's, the logdet aux's mean
      and covariance (with ``logdet_reg``), each MoE layer's counts and
      gate sums (twice under remat: the backward recomputes the layer),
      one of every gradient a call of its unit, in the parameter's dtype
      and gathered size (over the data line; a ``partial`` leaf's over
      the data and model lines, on a model line alone too), and the
      model line's, read off the step run shape only (`_model_line`;
      also as ``model_all_sum`` and ``model_all_sum_bytes``, a step's);
      then, once a step, the global norm's and
      the one that agrees the step commits.

    -> ``{"broadcast", "bytes" (theirs), "all_sum", "all_sum_bytes" (the
    tensors summed), "model_all_sum", "model_all_sum_bytes",
    "gathered" (the paths of the leaves gathered: parameters only)}``.
    One rank issues nothing."""
    mesh = mesh_of(shardings)
    named = {".".join(p): t for p, t in flat(params).items()}
    psh = {".".join(p): s for p, s in flat(shardings["params"]).items()}
    modes = tensor.leaf_modes({n: psh[n] for n in named})

    def ways(s):
        return math.prod(_count(axes, s.mesh)
                         for _, axes in _entries(s.spec, s.mesh))
    gsh = {n: model_block(psh[n]) if modes[n] == tensor.SPLIT else psh[n]
           for n in named}
    gways = {n: ways(gsh[n]) for n in named}
    plan = {"broadcast": 0, "bytes": 0, "all_sum": 0, "all_sum_bytes": 0,
            "model_all_sum": 0, "model_all_sum_bytes": 0,
            "gathered": sorted("params." + n for n in named
                               if gways[n] > 1)}
    if mesh.size == 1:
        return plan
    mb = tcfg.microbatches
    axes = data_axes(batch_shardings)
    d = _count(axes, mesh) if axes else 1
    m = mesh.shape.get("model", 1)
    calls = fsdp.gather_counts(cfg, list(named))
    for n, t in named.items():
        fwd, bwd = calls[fsdp.unit_of(n)]
        numel = t.numel() // (ways(psh[n]) // gways[n])
        if gways[n] > 1:
            cast = (tcfg.cast_params_bf16 and t.dtype == torch.float32
                    and jax_ndim(n, t) >= 2)
            size = 2 if cast else t.element_size()
            plan["broadcast"] += mb * (fwd + bwd) * gways[n]
            plan["bytes"] += mb * (fwd + bwd) * numel * size
        if d > 1 or modes[n] == tensor.PARTIAL:
            plan["all_sum"] += mb * fwd
            plan["all_sum_bytes"] += mb * fwd * numel * t.element_size()
    if d > 1:
        # the exchanges of one microbatch: the nll; each MoE layer's
        # counts (int64) and gate sums, per forward; the aux's two
        fwd = 2 if cfg.remat else 1
        moe = sum(n.rpartition(".")[2] == "router" for n in named)
        count = 1 + 2 * moe * fwd
        nbytes = d * 4 + moe * fwd * d * cfg.n_experts * (8 + 4)
        if tcfg.logdet_reg:
            w = cfg.d_model
            count += 2
            nbytes += d * w * 4 + d * w * w * 4
        plan["all_sum"] += mb * count
        plan["all_sum_bytes"] += mb * nbytes
    if m > 1 and any(v == tensor.SPLIT for v in modes.values()):
        line = _model_line(cfg, tcfg, shardings, batch_shardings, rows)
        plan["model_all_sum"] = line["all_sum"]
        plan["model_all_sum_bytes"] = line["bytes"]
        plan["all_sum"] += line["all_sum"]
        plan["all_sum_bytes"] += line["bytes"]
    if tcfg.opt.name in WHOLE_LEAF:
        gsize = (torch.empty((), dtype=tcfg.accum_dtype).element_size()
                 if mb > 1 else None)
        for n, t in named.items():
            if ways(psh[n]) > 1:
                plan["broadcast"] += ways(psh[n])
                plan["bytes"] += t.numel() * (gsize or t.element_size())
    # the global norm's (f64) and the agreement's
    plan["all_sum"] += 2
    plan["all_sum_bytes"] += 8 + 4
    return plan


def resident_bytes(shardings, shapes) -> int:
    """The bytes of one rank's blocks of a tree of whole tensors."""
    sh = flat(shardings)
    total = 0
    for path, t in flat(tree_map(lambda p, x: x, shapes)).items():
        total += math.prod(shard_shape(t.shape, sh[path])) * t.element_size()
    return total
