"""The port's MoE archs against the JAX package at the smoke configs:
llama4-maverick (dense/moe pairs, top-1, a shared expert, bf16
parameters) and qwen2-moe (every layer MoE, top-2, shared experts).
The checks are tests/_torch_model_twins.py's."""
import pytest

import _torch_model_twins as T

ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe-a2.7b"]
twins = T.twin_fixture(ARCHS)


@pytest.mark.parametrize("check", sorted(T.CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_arch_twin(twins, arch, check):
    T.CHECKS[check](twins(arch))
