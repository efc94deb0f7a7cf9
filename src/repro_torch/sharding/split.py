"""The data-parallel split of a training step: what GSPMD does to the JAX
step's batch axis on the data axes of a mesh, for a port whose ranks are
processes.

Inside `data_split(line)` each rank of ``line`` (the ranks that differ
only along the data axes, `launch.mesh.GridMesh.line`) holds its share of
every global microbatch and computes on it alone.  Four things of the
global program read statistics of the whole batch, and each reduces them
over the line so that the result is the global one:

- the token cross-entropy divides its sum by the global token count
  (`rows`), so the ranks' losses add up to the global mean;
- the logdet aux takes the mean and the covariance of all rows (`total`);
- MoE takes its capacity from the global token count, its slots in the
  global token-major order (`each`: every rank's per-expert counts), and
  the balance aux's means over the global tokens (`total`);
- the gradients of the ranks' shares are summed, unit by unit in the
  backward (`sharding.fsdp`).

**Every reduction gives every rank the same bits.**  `each` gathers
every rank's tensor by one all_sum of a stack that holds it at the
rank's row and zeros elsewhere (adding zeros is exact), and `total` adds
the rows in rank order.  A gradient is summed by one all_sum: the
backends' all-reduce algorithms (gloo's ring and halving-doubling, on
the host also for CUDA tensors; NCCL's ring and tree) reduce each
element once and hand that one result to every rank, which
`tools/allreduce_bits.py` checks on each backend.  Only ``broadcast``
and ``all_reduce`` are used: gloo takes CUDA tensors for these alone.

The split in force is the process's, not a thread's: on the card the
autograd engine runs the backward, and so a checkpoint's recomputation
of a MoE layer's exchanges, on a thread of its own.

**The backward of `total` is the identity.**  Whatever reads a reduced
statistic is computed alike on every rank, so the gradient that reaches
it is already the same on every rank; each rank passes it to its own
share, and the sum of the ranks' parameter gradients is the global one.
A sum in the backward would count it once per rank.  So a metric counts
a replicated term once (`whole`).

A line of one rank, or no `data_split`, splits nothing: no function here
issues a collective, and each returns its input, so one rank's step is
bitwise the single-device step.  ``data_split(size=P)`` without a line
is a shape-only split (the dry run on meta tensors): every rank is taken
to hold this rank's values, and nothing is exchanged.
"""
from __future__ import annotations

import types
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core import mesh as core_mesh

__all__ = ["Split", "data_split", "current", "rows", "each", "stacked",
           "ordered_sum", "total", "whole"]

_STATE = types.SimpleNamespace(split=None)


@dataclass(frozen=True)
class Split:
    """``size`` ranks share every global microbatch, this one being
    ``rank``; ``line`` is their `core.mesh.Mesh` (None: shape only)."""
    size: int
    rank: int
    line: Optional[core_mesh.Mesh] = None


@contextmanager
def data_split(line: Optional[core_mesh.Mesh] = None, *,
               size: Optional[int] = None):
    """The step's loss code inside runs on this rank's share of the batch
    of ``line`` (or of a shape-only ``size``-rank line)."""
    prev = _STATE.split
    if line is not None and line.size > 1:
        _STATE.split = Split(line.size, line.rank, line)
    elif line is None and size is not None and size > 1:
        _STATE.split = Split(size, 0)
    else:
        _STATE.split = None
    try:
        yield
    finally:
        _STATE.split = prev


def current() -> Optional[Split]:
    """The split in force, or None (one rank: nothing splits)."""
    return _STATE.split


def rows(n: int) -> int:
    """The global count of ``n`` rows a rank (``n`` alone)."""
    s = current()
    return n if s is None else n * s.size


def stacked(t: torch.Tensor, size: int, rank: int,
            line: Optional[core_mesh.Mesh]) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` (this one being ``rank`` of
    ``line``) in rank order, the same bits on every rank; one all_sum of a
    stack that holds ``t`` at this rank's row and zeros elsewhere (no
    gradient).  Shape only without a line: ``t`` at every row (the
    all_sum `core_mesh.tally`'d)."""
    t = t.detach()
    if line is None:
        out = t[None].expand(size, *t.shape).clone()
        core_mesh.tally("all_sum", out)
        return out
    stack = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype,
                        device=t.device)
    stack[rank] = t
    return core_mesh.all_sum(line, stack)


def each(t: torch.Tensor) -> torch.Tensor:
    """(ranks, *t.shape): every rank's ``t`` of the data line in rank
    order (`stacked`); ``t[None]`` with no split."""
    s = current()
    if s is None:
        return t.detach()[None]
    return stacked(t, s.size, s.rank, s.line)


def ordered_sum(stack: torch.Tensor) -> torch.Tensor:
    """The sum of a stack's rows in rank order."""
    out = stack[0]
    for i in range(1, stack.shape[0]):
        out = out + stack[i]
    return out


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return ordered_sum(each(t))

    @staticmethod
    def backward(ctx, g):
        return g


def total(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of ``t`` in rank order (``t`` alone); its
    backward is the identity (see the module docstring)."""
    if current() is None:
        return t
    return _Total.apply(t)


def whole(t: torch.Tensor) -> torch.Tensor:
    """A metric's value over the whole batch from this rank's share of it
    (``t`` alone): `total` of the detached share."""
    if current() is None:
        return t
    return ordered_sum(each(t))
