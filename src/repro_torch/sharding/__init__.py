"""Sharding -- counterpart of `repro.sharding`: the rules that lay a
train state, a batch and the serving caches out on a mesh (`rules`), the
activation hints (`hints`), the port's layout of a state on a mesh of
processes and its training step there (`layout`), and the data-parallel
split of that step's arithmetic (`split`)."""
from repro_torch.sharding.rules import (
    PartitionSpec, Sharding, batch_spec, cache_shardings, make_rules,
    param_shardings, param_specs,
)

__all__ = ["make_rules", "param_specs", "param_shardings", "batch_spec",
           "cache_shardings", "PartitionSpec", "Sharding"]
