"""The port's encoder-decoder and vision archs against the JAX package
at the smoke configs: whisper (a bidirectional encoder with sinusoidal
positions, decoder blocks with cross-attention, GELU) and
llama-3.2-vision (self-attention super-blocks with a gated
cross-attention block every 2nd layer).  The checks are
tests/_torch_model_twins.py's."""
import pytest

import _torch_model_twins as T

ARCHS = ["whisper-tiny", "llama-3.2-vision-11b"]
twins = T.twin_fixture(ARCHS)


@pytest.mark.parametrize("check", sorted(T.CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_encdec_arch_twin(twins, arch, check):
    T.CHECKS[check](twins(arch))
