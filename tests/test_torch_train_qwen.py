"""CPU twin of one train step of qwen2.5-3b at its smoke config against
the JAX package's jitted step: adamw (microbatches 2, bf16 gradient
compression) and adafactor, with the logdet aux; the checks of
`tests/_torch_train_twins.py` (sgd: tests/test_torch_train.py)."""
from __future__ import annotations

import pytest

from _torch_train_twins import check_case, run_case


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_step_matches_jax_qwen(name):
    check_case(run_case("qwen2.5-3b", name))
