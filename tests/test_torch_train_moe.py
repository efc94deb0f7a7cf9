"""CPU twin of one train step of a MoE arch (qwen2-moe-a2.7b at its smoke
config, its load-balance aux summed over the layers into the loss)
against the JAX package's jitted step, sgd and adamw (microbatches 2,
bf16 gradient compression), with the logdet aux: the checks of
`tests/_torch_train_twins.py` (adafactor:
tests/test_torch_train_adafactor.py)."""
from __future__ import annotations

import pytest

from _torch_train_twins import check_case, run_case


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_train_step_matches_jax_moe(name):
    r = run_case("qwen2-moe-a2.7b", name)
    assert "moe_balance" in r["metrics"]
    check_case(r)
