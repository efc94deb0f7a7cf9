"""Sharding -- counterpart of `repro.sharding`: the rules that lay a
train state, a batch and the serving caches out on a mesh (`rules`), the
activation hints (`hints`), the port's layout of a state on a mesh of
processes and its training step there (`layout`), the data-parallel
split of that step's arithmetic (`split`), its tensor and expert
parallel split on the "model" axis (`tensor`), and the gather of its
parameters one unit at a time with each unit's gradient reduced in its
backward (`fsdp`)."""
from repro_torch.sharding.rules import (
    PartitionSpec, Sharding, batch_spec, cache_shardings, make_rules,
    param_shardings, param_specs,
)

__all__ = ["make_rules", "param_specs", "param_shardings", "batch_spec",
           "cache_shardings", "PartitionSpec", "Sharding"]
