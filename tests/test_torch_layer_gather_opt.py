"""The unit-by-unit mesh step (`sharding.fsdp`) on a 2x2 grid of gloo
ranks against the JAX package's jitted step on a fake-device 2x2 mesh
(`_torch_layer_gather`), for the step's options: two microbatches with
``grad_compression`` and ``cast_params_bf16`` (each block cast to bf16
before its gather; the gradient reduced in f32; the logdet aux on), and
SGD.  Gates: the gradient blocks gathered whole against ``jax.grad``
(averaged over the microbatches; plus COMPRESSION_ULP of each leaf's
largest element under compression), the metrics, shared blocks bitwise,
the collectives equal to `layout.step_plan` (the bf16 wholes' bytes)."""
from __future__ import annotations

import pytest

import _torch_layer_gather as LG

CASES = {"micro_cast": ("gemma3-1b", {"optimizer": "adamw",
                                      "logdet_reg": 0.05,
                                      "microbatches": 2,
                                      "grad_compression": True,
                                      "cast_params_bf16": True}),
         "sgd": ("gemma3-1b", {"optimizer": "sgd", "logdet_reg": 0.05})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return LG.run(tmp_path_factory.mktemp("layer_gather_opt"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_options_are_the_jax_meshs_step(runs, name):
    LG.check_against_jax(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_options_share_blocks_bitwise(runs, name):
    LG.check_shared_bits(runs, name)


@pytest.mark.parametrize("name", list(CASES))
def test_layer_gather_options_collectives_equal_the_plan(runs, name):
    LG.check_plan(runs, name)


def test_the_cast_gathers_bf16_wholes(runs):
    """``cast_params_bf16``: the wholes of every cast leaf cross the wire
    at half the bytes of the uncast step's (the same grid's plan)."""
    cast = runs["ranks"][0]["micro_cast"]["plan"]
    plain = runs["ranks"][0]["sgd"]["plan"]
    assert cast["broadcast"] == 2 * plain["broadcast"]      # 2 microbatches
    assert cast["bytes"] < 2 * plain["bytes"]
