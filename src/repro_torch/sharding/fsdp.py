"""Parameters gathered one unit at a time on a mesh -- the port's
counterpart of the per-layer all-gathers and gradient reductions that
GSPMD inserts for the JAX rules' FSDP axes (`repro.sharding.rules`: the
embed axis of every weight on the data axes), for a port whose ranks
are processes.

**Units.**  A unit is a block module that the model's stack runner calls
(`models.model._run_stack`, `_encode`): ``blocks.3``,
``dense_blocks.0.1``, ``moe_blocks.0``, ``shared_attn``, ``extra_ssm.0``,
... -- a parameter name's top-level entry and the indices that follow it
(`units`).  Every parameter outside them (``embed``, ``head``,
``final_norm``, ``enc_norm``) is the *root* unit, ``""``.

**The gather is an autograd op** (`_Gather`).  Its inputs are a unit's
blocks (the model's parameters, laid out by `layout.shard`), its outputs
the tensors the unit computes on (`layout.gather_leaf`; with a cast
rule, the cast of each block gathered: the same values at the cast's
bytes): a leaf that the step computes model-parallel
(`tensor.leaf_modes`: ``split``) gathered over the rank's data line
only, so that the rank keeps its model block (the spec without "model",
`layout.model_block`); every other leaf whole.  Its backward sums each
gradient over the rank's data line -- over the data and model lines at
once for a ``partial`` leaf, whose ranks of a model line each hold a
part of it (one all_sum a tensor, in the block's dtype: every rank of
the line gets the same bits, `tools/allreduce_bits.py`) -- and returns
the rank's block of it (`layout.local_block`), so autograd
differentiates the blocks and a gathered gradient lives only until its
unit's backward ends.  An all_sum then a cut, not a reduce-scatter:
gloo takes CUDA tensors for broadcast and all_reduce alone (`split`).

**Installed for one step** (`sharded`, `layout.mesh_grad_fn`'s scope).
Each unit module's ``forward`` is wrapped: it gathers the unit, puts the
whole tensors where the module reads its parameters (the module's
``__dict__``, its ``_parameters`` entry set to None meanwhile, so that
neither ``named_parameters`` nor anything that walks it sees a whole),
runs, and puts the blocks back -- in a ``finally``, which also runs when
``torch.utils.checkpoint`` stops a recomputation early.  So:

- under ``cfg.remat`` each unit runs inside a non-reentrant checkpoint,
  which keeps none of its tensors, and the backward's recomputation
  gathers the unit again; every rank of a line runs the same backward,
  so the gathers come in the same order on each;
- a unit that runs outside a checkpoint (``remat=False``, the encoder's
  and zamba2's trailing SSM blocks) keeps no whole either: while a
  microbatch's forward runs (`gathered`), a ``saved_tensors_hooks`` pair
  packs a saved whole (or its cast to the activations' dtype, or a view
  of either) as a reference to its unit's call, and the first unpack of
  that call in the backward gathers the unit again, once, for the call's
  backward (dropped by `_Gather`'s backward, the call's last node);
- the root unit is gathered once per microbatch (`gathered`) and held by
  the ops that saved it until its backward ends, so the tied embedding's
  gradients from the lookup, the unembedding and the logdet aux are
  summed by autograd before its one reduction.

A unit called several times a step (zamba2's ``shared_attn``) is
gathered and reduced per call; autograd sums the calls' block gradients
(rounding only, against one reduction of their sum).

**One device** takes a scope of its own under ``cast_params_bf16``
(``sharded(model)``: every leaf whole, nothing summed), so that each
unit casts its parameters as it is called, a checkpoint's recomputation
included (`train.step.make_loss_fn`).

`gather_counts` gives, per unit, how many times a microbatch gathers it
in its forward and in its backward (`layout.step_plan` counts from
it).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.sharding import tensor
from repro_torch.sharding.rules import PartitionSpec, Sharding

__all__ = ["units", "unit_of", "sharded", "installed", "gathered", "gather",
           "reduce", "gather_counts", "HighWater",
           "watching", "note"]

ROOT = ""

# the inner lists of the super-blocks, each closed by one more call
# (`models.model._run_stack`'s pair_moe, vlm and hybrid plans: the MoE,
# cross-attention and shared attention blocks)
_INNER_LISTS = ("dense_blocks", "self_blocks", "ssm_blocks")


def unit_of(name: str) -> str:
    """The unit of parameter ``name``: its top-level entry and the indices
    that follow it, or `ROOT` for a parameter of the model itself."""
    parts = name.split(".")
    if len(parts) == 1:
        return ROOT
    k = 1
    while k < len(parts) - 1 and parts[k].isdigit():
        k += 1
    return ".".join(parts[:k])


def units(model) -> Dict[str, List[str]]:
    """{unit: its parameter names} in `named_parameters` order (the root
    unit `ROOT` among them)."""
    out: Dict[str, List[str]] = {}
    for name, _ in model.named_parameters():
        out.setdefault(unit_of(name), []).append(name)
    return out


@dataclass
class _Plan:
    """One step's installation: each parameter's `tensor.leaf_modes` mode
    and the sharding it is gathered and cut by (``gathers``), by name; the
    data line the gradients are summed over (None: no sum), the line of
    the data and model axes a ``partial`` leaf's gradient is summed over;
    the cast rule in force (``cast(name, block) -> dtype or None``)."""
    modes: Dict[str, str]
    gathers: Dict[str, object]
    line: Optional[object]
    wide: Optional[object] = None
    cast: Optional[Callable] = None
    # a layer unit's gather (its autograd node) -> its call, while the
    # unit's forward runs (see `_pack`)
    nodes: Dict[object, "_Call"] = field(default_factory=dict)


@dataclass
class _Unit:
    name: str
    names: List[str]
    slots: List[Tuple[torch.nn.Module, str]]
    plan: _Plan


@dataclass
class _Call:
    """One call of a unit: its blocks as given, and the wholes gathered
    again for its backward (see `_unpack`)."""
    unit: _Unit
    blocks: tuple
    again: Optional[list] = None


class HighWater:
    """The most bytes of gathered whole parameters alive at once
    (``bytes``), and the most layer units with a whole alive at once
    (``units``), looked at by weak references to every whole that
    `gather` makes (or that `note` is given), at every gather, every
    reduction and every `note` while `watching`."""

    def __init__(self):
        self.bytes = 0
        self.units = 0
        self._refs = []

    def _note(self, unit: str, wholes, blocks) -> None:
        for w, b in zip(wholes, blocks):
            if w is not b:
                self._refs.append((unit, weakref.ref(w),
                                   w.numel() * w.element_size()))
        self.look()

    def look(self) -> None:
        self._refs = [r for r in self._refs if r[1]() is not None]
        self.bytes = max(self.bytes, sum(n for _, _, n in self._refs))
        self.units = max(self.units, len({u for u, _, _ in self._refs
                                          if u != ROOT}))


_WATCHING: List[HighWater] = []


@contextlib.contextmanager
def watching():
    """A `HighWater` of the gathers made in its scope."""
    hw = HighWater()
    _WATCHING.append(hw)
    try:
        yield hw
    finally:
        _WATCHING.remove(hw)


def gather(unit: _Unit, blocks) -> List[torch.Tensor]:
    """The whole tensors of a unit's blocks: each block cast by the
    plan's rule, then `layout.gather_leaves` (every rank of a line calls
    it for the same unit, in the same order)."""
    from repro_torch.sharding import layout
    plan = unit.plan
    cast = []
    for name, b in zip(unit.names, blocks):
        dt = plan.cast(name, b) if plan.cast is not None else None
        cast.append(b if dt is None else b.to(dt))
    out = layout.gather_leaves(cast, [plan.gathers[n] for n in unit.names])
    note(unit.name, out, blocks)
    return out


def note(unit: str, wholes, blocks) -> None:
    """Every `HighWater` that is `watching` holds a weak reference to each
    of ``wholes`` that is not its block (the matching ``blocks`` entry
    itself), of ``unit``, and looks at what is alive."""
    for hw in _WATCHING:
        hw._note(unit, wholes, blocks)


def reduce(unit: _Unit, grads, blocks) -> List[torch.Tensor]:
    """The rank's block of each gathered gradient summed over the plan's
    data line (a ``partial`` leaf's over its data and model lines), in its
    block's dtype (a missing gradient counts as zeros): one all_sum a
    gradient, all issued before the first is waited on."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.sharding import layout
    plan = unit.plan
    for hw in _WATCHING:
        hw.look()
    whole, works = [], []
    for name, g, b in zip(unit.names, grads, blocks):
        line = plan.wide if plan.modes[name] == tensor.PARTIAL else plan.line
        if g is None:
            g = torch.zeros(layout.whole_shape(b.shape, plan.gathers[name]),
                            dtype=b.dtype, device=b.device)
        elif line is not None:
            # a copy: the gradient handed to a backward may be shared
            g = g.to(b.dtype, copy=True).contiguous()
        else:
            g = g.to(b.dtype)
        if line is not None:        # all issued, then waited on
            works.append(core_mesh.all_sum(line, g, async_op=True))
        whole.append(g)
    for w in works:
        w.wait()
    return [layout.local_block(g, plan.gathers[n])
            for n, g in zip(unit.names, whole)]


class _Gather(torch.autograd.Function):
    """blocks -> whole tensors; backward: the whole gradients summed over
    the data line, cut to the blocks (see the module docstring)."""

    @staticmethod
    def forward(ctx, call, *blocks):
        ctx.call = call
        return tuple(gather(call.unit, blocks))

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        call.again = None
        return (None,) + tuple(reduce(call.unit, grads, call.blocks))


def _read(slots):
    return tuple(sub._parameters[attr] for sub, attr in slots)


@contextlib.contextmanager
def _swapped(slots, wholes):
    """The wholes where ``slots``' modules read their parameters (their
    ``__dict__``; the ``_parameters`` entries None meanwhile)."""
    held = _read(slots)
    try:
        for (sub, attr), w in zip(slots, wholes):
            sub._parameters[attr] = None
            sub.__dict__[attr] = w
        yield
    finally:
        for (sub, attr), b in zip(slots, held):
            sub.__dict__.pop(attr, None)
            sub._parameters[attr] = b


@contextlib.contextmanager
def _called(unit: _Unit):
    """One call of ``unit``: gathered by `_Gather`, its wholes swapped in
    and registered for `_pack` while it runs."""
    call = _Call(unit, _read(unit.slots))
    wholes = _Gather.apply(call, *call.blocks)
    # the root is held, not packed; no node without autograd
    node = None if unit.name == ROOT else wholes[0].grad_fn
    if node is not None:
        unit.plan.nodes[node] = call
    try:
        with _swapped(unit.slots, wholes):
            yield
    finally:
        unit.plan.nodes.pop(node, None)


def _wrap(unit: _Unit, forward):
    def gathered_forward(*args, **kw):
        with _called(unit):
            return forward(*args, **kw)
    return gathered_forward


def _slots(model, names):
    out = []
    for n in names:
        mod, _, attr = n.rpartition(".")
        out.append((model.get_submodule(mod) if mod else model, attr))
    return out


@contextlib.contextmanager
def sharded(model, shardings: Optional[dict] = None, line=None, wide=None):
    """For its scope, every unit module of ``model`` (whose parameters hold
    its blocks) gathers its unit when called, and the root unit is
    gathered by `gathered`; gradients are summed over ``line`` (a
    `core.mesh.Mesh`; None: not summed), a ``partial`` leaf's over
    ``wide`` (the data and model lines; None: not summed).
    ``shardings`` maps a parameter name to its `rules.Sharding` (None:
    every parameter whole, one rank's scope)."""
    from repro_torch.sharding import layout
    if shardings is None:
        whole = Sharding(None, PartitionSpec())
        shardings = {n: whole for n, _ in model.named_parameters()}
    modes = tensor.leaf_modes(shardings, model.cfg)
    plan = _Plan(modes, {n: layout.model_block(s) if modes[n] == tensor.SPLIT
                         else s for n, s in shardings.items()}, line, wide)
    made = {}
    for name, names in units(model).items():
        made[name] = _Unit(name, names, _slots(model, names), plan)
    wrapped = []
    try:
        for name, unit in made.items():
            if name == ROOT:
                continue
            mod = model.get_submodule(name)
            mod.forward = _wrap(unit, mod.forward)
            wrapped.append(mod)
        model.__dict__["_fsdp_units"] = made
        yield plan
    finally:
        model.__dict__.pop("_fsdp_units", None)
        for mod in wrapped:
            mod.__dict__.pop("forward", None)


def installed(model) -> bool:
    """Whether a `sharded` scope is in force on ``model``."""
    return "_fsdp_units" in model.__dict__


def _pack(plan: _Plan):
    """A saved tensor that is a whole (an output of a layer unit's
    `_Gather`: a view of an unsplit block is not), a dtype cast of one
    (the model's ``w.to(x.dtype)``), or a view of either -> (call, index,
    dtype to cast to or None, view or None); anything else as it is."""
    def pack(t):
        key = t if t._base is None else t._base
        fn, i, dtype = key.grad_fn, key.output_nr, None
        if fn is not None and fn.name() == "ToCopyBackward0":
            (fn, i), dtype = fn.next_functions[0], key.dtype
        call = plan.nodes.get(fn)
        if call is None:
            return t
        view = None if t is key else (t.size(), t.stride(),
                                      t.storage_offset())
        return (call, i, dtype, view)
    return pack


def _unpack(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    call, i, dtype, view = packed
    if call.again is None:
        with torch.no_grad():
            call.again = gather(call.unit, call.blocks)
    w = call.again[i] if dtype is None else call.again[i].to(dtype)
    return w if view is None else w.as_strided(*view)


@contextlib.contextmanager
def gathered(model, cast: Optional[Callable] = None):
    """One microbatch's forward under `sharded`: the root unit gathered and
    swapped in, the saved-tensor hooks on, ``cast`` (``cast(name, block)
    -> dtype or None``) applied to every unit's blocks before their
    gather (here and in the backward's gathers).  Yields whether a
    `sharded` scope is in force (outside one: nothing happens)."""
    made = model.__dict__.get("_fsdp_units")
    if made is None:
        yield False
        return
    root = made.get(ROOT)
    plan = next(iter(made.values())).plan
    plan.cast = cast
    with (contextlib.nullcontext() if root is None else _called(root)), \
            torch.autograd.graph.saved_tensors_hooks(_pack(plan), _unpack):
        yield True


def gather_counts(cfg, names) -> Dict[str, Tuple[int, int]]:
    """{unit: (gathers in a microbatch's forward, gathers in its backward)}
    for the parameter ``names`` of a model of ``cfg`` under `sharded`:
    the root once (held through the backward); a unit once per call in
    the forward, and in the backward once per call by its checkpoint's
    recomputation or the saved-tensor hooks -- and, under ``cfg.remat``,
    once more for each unit of a super-block's inner list (the
    super-block's own recomputation runs it; it stops before the call
    that closes the list).  zamba2's ``shared_attn`` is called once per
    super-block."""
    out = {}
    n_super = len({n.split(".")[1] for n in names
                   if n.startswith("ssm_blocks.")})
    for u in {unit_of(n) for n in names}:
        top = u.split(".")[0]
        if u == ROOT:
            out[u] = (1, 0)
            continue
        calls = n_super if top == "shared_attn" else 1
        back = calls
        if cfg.remat and top in _INNER_LISTS:
            back = 2 * calls
        out[u] = (calls, back)
    return out

