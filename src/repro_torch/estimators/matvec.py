"""Back-compat shim: the matvec backends are the operator package.

Counterpart of `repro.estimators.matvec`.  The backends that lived here
grew into `repro_torch.estimators.operators` (Kronecker / Toeplitz /
stencil backends, matrix-free CG); this module re-exports the original
names so callers of the old path keep working.  The JAX shim's
``rowwise_matvec_specs`` is not ported: it names shard_map
PartitionSpecs, and the port's mesh shards by rank, not by spec.
"""
from __future__ import annotations

from repro_torch.estimators.operators import (          # noqa: F401
    BatchedOperator,
    DenseOperator,
    LinearOperator,
    ShardedOperator,
    as_operator,
)

__all__ = ["LinearOperator", "DenseOperator", "BatchedOperator",
           "ShardedOperator", "as_operator"]
