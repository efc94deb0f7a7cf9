"""The mesh step with its parameters gathered one unit at a time
(`sharding.fsdp`) on a 2x2 grid of gloo ranks against the JAX package's
jitted step on a fake-device 2x2 mesh (`_torch_layer_gather`): zamba2-7b,
whose shared attention block runs once per super-block (gathered and
reduced per call; the SSM gate 1e-4), and gemma3-1b with ``remat=False``
(no checkpoint: the saved-tensor hooks gather each unit again for its
backward).  Gates: the gradient blocks gathered whole against
``jax.grad``, the metrics against the jitted step's, shared blocks
bitwise, the collectives equal to `layout.step_plan`."""
from __future__ import annotations

import pytest

import _torch_layer_gather as LG

CASES = {"zamba2": ("zamba2-7b", {"optimizer": "adamw"}),
         "gemma3_no_remat": ("gemma3-1b", {"optimizer": "adamw",
                                           "logdet_reg": 0.05,
                                           "remat": False})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return LG.run(tmp_path_factory.mktemp("layer_gather"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_step_is_the_jax_meshs_step(runs, name):
    LG.check_against_jax(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_blocks_are_shared_bitwise(runs, name):
    LG.check_shared_bits(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_collectives_equal_the_plan(runs, name):
    LG.check_plan(runs, name)
