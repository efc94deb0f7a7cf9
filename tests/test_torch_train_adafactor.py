"""CPU twin of one Adafactor train step of the MoE arch (qwen2-moe-a2.7b)
and the depth-2 arch (zamba2-7b) at their smoke configs against the JAX
package's jitted step, with the logdet aux: the factored moments of
every stacked leaf (vr over its rows, one vc shared by its layers) and
the whole-leaf RMS clip, through the checks of
`tests/_torch_train_twins.py`."""
from __future__ import annotations

import pytest

from _torch_train_twins import check_case, run_case


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "zamba2-7b"])
def test_adafactor_step_matches_jax(arch):
    check_case(run_case(arch, "adafactor"))
