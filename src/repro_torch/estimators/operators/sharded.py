"""Mesh-sharded backend: a row-distributed dense operator.

Counterpart of `repro.estimators.operators.sharded`.  Rank ``p`` of the
mesh (`repro_torch.core.mesh`) keeps rows ``[p L, (p + 1) L)`` of the
matrix on its device, the layout of the exact mesh schedule, so a matrix
passes from the exact path to the estimators without a reshuffle.  Probe
slabs are replicated: every rank holds the same (n, k) slab.  ``mm``
multiplies the rank's (L, n) block against it through K5
(`repro_torch.kernels.ops.matvec`) and concatenates the row chunks on
every rank (P broadcasts, `mesh.gather_rows`).

Unlike the JAX package, which is single-controller, every rank is a
process: each constructs the operator from the same full matrix and runs
the same estimator calls.  `rowwise_matvec_specs` (the ``shard_map``
partition specs of the JAX module) has no meaning here and is not ported.
"""
from __future__ import annotations

import torch

from repro_torch.core import mesh as _mesh
from repro_torch.estimators.operators.base import (
    LinearOperator, PlanHints, check_square,
)
from repro_torch.kernels import ops as _kops

__all__ = ["ShardedOperator"]


class ShardedOperator(LinearOperator):
    """Row-distributed dense operator over a 1-D mesh.

    ``n`` must be divisible by the mesh size (pad with
    `repro_torch.core.pad_to_multiple`, which leaves the determinant
    unchanged).  This rank's block is copied to ``mesh.device``; ``a``
    keeps the full matrix it was built from (the gradient rules'
    parameter, `estimators.grad`).
    """

    def __init__(self, a: torch.Tensor, mesh: _mesh.Mesh):
        a = torch.as_tensor(a)
        check_square(a.shape)
        if a.shape[0] % mesh.size:
            raise ValueError(
                f"N={a.shape[0]} not divisible by mesh size {mesh.size}; "
                "pad with repro_torch.core.pad_to_multiple first")
        self.mesh = mesh
        self.a = a
        self.shape = tuple(a.shape)
        self.dtype = a.dtype
        self.device = mesh.device
        self.rows = mesh.block(a.shape[0])
        self.local = a[self.rows].to(mesh.device, copy=True).contiguous()

    def mm(self, v):
        v = v.to(self.dtype)
        out = torch.empty((self.n, v.shape[1]), dtype=self.dtype,
                          device=self.device)
        return _mesh.gather_rows(self.mesh, _kops.matvec(self.local, v), out)

    def rmm(self, v):
        # (v^T A)^T: the rank's rows of v against its block, summed over
        # the ranks
        vt = v.to(self.dtype)[self.rows].transpose(-1, -2)
        return _mesh.all_sum(self.mesh, (vt @ self.local).transpose(-1, -2)
                             .contiguous())

    def diag(self):
        d = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        d[self.rows] = torch.diagonal(self.local[:, self.rows])
        return _mesh.all_sum(self.mesh, d)

    def trace_hint(self):
        t = torch.diagonal(self.local[:, self.rows]).sum().reshape(1)
        return _mesh.all_sum(self.mesh, t)[0]

    def to_dense(self):
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        return _mesh.gather_rows(self.mesh, self.local, out)

    def plan_hints(self):
        # dense cost split across the mesh; rows are resident, so the
        # exact mesh schedule stays available
        n = self.n
        return PlanHints(structure="sharded",
                         matvec_flops=2.0 * n * n / self.mesh.size,
                         materializable=True, device_count=self.mesh.size)
