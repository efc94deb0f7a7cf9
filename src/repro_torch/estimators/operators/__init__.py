"""Linear-operator backends for the matrix-free estimators.

Counterpart of `repro.estimators.operators`.  Every estimator and solver
in `repro_torch.estimators` touches the matrix only through the
`LinearOperator` protocol (base.py).  Ported backends:

  DenseOperator      in-memory (n, n) tensor
  BatchedOperator    (B, n, n) stack, one batched product per step
  StencilOperator    banded product through K8 -- O(nb n) memory
  ShardedOperator    row block per rank of a mesh, products through K5
  KroneckerOperator  A ⊗ B from its factors, two reshaped products
  ToeplitzOperator   first column (and row), a circulant FFT product

plus `cg_solve` (solve.py), Jacobi-preconditioned conjugate gradient on
any of them.
"""
from __future__ import annotations

import torch

from repro_torch.estimators.operators.base import (
    LinearOperator, PlanHints, check_square, device_of, is_operator,
    resolve_device,
)
from repro_torch.estimators.operators.batched import BatchedOperator
from repro_torch.estimators.operators.dense import DenseOperator
from repro_torch.estimators.operators.kron import KroneckerOperator
from repro_torch.estimators.operators.sharded import ShardedOperator
from repro_torch.estimators.operators.stencil import StencilOperator
from repro_torch.estimators.operators.toeplitz import ToeplitzOperator

__all__ = [
    "LinearOperator", "PlanHints", "DenseOperator", "StencilOperator",
    "BatchedOperator", "KroneckerOperator", "ToeplitzOperator",
    "ShardedOperator", "as_operator", "operator_on", "is_operator",
    "check_square", "device_of", "resolve_device", "CGResult", "cg_solve",
]

def as_operator(a, *, mesh=None) -> LinearOperator:
    """Coerce a matrix or an operator to the estimator protocol.

    An (n, n) tensor or array becomes a `DenseOperator` (a tensor keeps
    its device), or with a ``mesh`` of more than one rank a
    `ShardedOperator` (this rank's rows on ``mesh.device``); a (B, n, n)
    stack a `BatchedOperator`, as in the JAX package; an existing
    operator, including a duck-typed one, passes through untouched.
    """
    if is_operator(a):
        return a
    a = torch.as_tensor(a)
    if a.dim() == 3:
        return BatchedOperator(a)
    if mesh is not None and mesh.size > 1:
        return ShardedOperator(a, mesh)
    return DenseOperator(a)


def operator_on(a, device, *, mesh=None) -> LinearOperator:
    """`as_operator` of ``a`` on ``device`` (`resolve_device`: ``None`` is
    the card).  An array or tensor is moved there; an operator on another
    device through its ``to``, and one without ``to`` raises.  The
    caller's tensor or operator is left alone.  With a ``mesh`` of more
    than one rank an (n, n) array or tensor becomes a `ShardedOperator` on
    ``mesh.device``, which ``device`` must then name (or leave ``None``); a
    stack stays a `BatchedOperator` on ``device``.
    """
    if (mesh is not None and mesh.size > 1 and not is_operator(a)
            and getattr(a, "ndim", 2) != 3):
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device!r} is not the mesh's device "
                             f"{mesh.device} on this rank")
        return ShardedOperator(a, mesh)
    dev = resolve_device(device)
    if not is_operator(a):
        a = torch.as_tensor(a).to(dev)
    op = as_operator(a)
    if device_of(op) == dev:
        return op
    if not hasattr(op, "to"):
        raise ValueError(
            f"the operator runs on {device_of(op)} and has no .to() to move "
            f"it to {dev}; build it there or pass device={str(device_of(op))!r}")
    return op.to(dev)


from repro_torch.estimators.operators.solve import CGResult, cg_solve  # noqa: E402
