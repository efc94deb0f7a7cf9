"""CPU twin of one train step of an arch with a depth-2 stack (zamba2-7b
at its smoke config: its SSM blocks are an (n, per) stack in the JAX
tree, the shared attention block one unstacked copy) against the JAX
package's jitted step, sgd and adamw (microbatches 2, bf16 gradient
compression), with the logdet aux: the checks of
`tests/_torch_train_twins.py` (adafactor:
tests/test_torch_train_adafactor.py)."""
from __future__ import annotations

import pytest

from _torch_train_twins import check_case, run_case


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_train_step_matches_jax_depth2(name):
    r = run_case("zamba2-7b", name)
    assert any(n.startswith("ssm_blocks.1.1.")
               for n, _ in r["state"]["params"].named_parameters())
    check_case(r)
