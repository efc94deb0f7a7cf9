"""The port's SSM archs against the JAX package at the smoke configs:
mamba2 (SSD, attention-free) and zamba2 (SSM super-blocks around ONE
shared attention block, plus an extra SSM layer).  The shared checks are
tests/_torch_model_twins.py's; the chunked SSD scan with a padded tail
is held here against the JAX one."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.models import ssm as jssm

import _torch_model_twins as T
from repro_torch.models import ssm

ARCHS = ["mamba2-370m", "zamba2-7b"]
twins = T.twin_fixture(ARCHS)


@pytest.mark.parametrize("check", sorted(T.CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_arch_twin(twins, arch, check):
    T.CHECKS[check](twins(arch))


@pytest.mark.parametrize("t", [20, 16, 5])
def test_ssd_chunked_matches_jax(t):
    """The chunked scan at T = 20 over 8-token chunks (a padded tail that
    is cut), 16 (two whole chunks) and 5 (one short chunk): y and the
    final state within 1e-5 of the JAX scan on the same inputs, and the
    backward finite (the intra-chunk decay is masked before exp)."""
    jcfg, cfg = T.configs("mamba2-370m", ssm_chunk=8)
    _, nh, hp, g, st, _, _ = ssm._dims(cfg)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, nh, hp)).astype(np.float32)
    bm = rng.standard_normal((2, t, g, st)).astype(np.float32)
    cm = rng.standard_normal((2, t, g, st)).astype(np.float32)
    dt = np.abs(rng.standard_normal((2, t, nh))).astype(np.float32)
    a = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(v) for v in (x, bm, cm, dt, a)),
                               jcfg)
    tx = torch.from_numpy(x).requires_grad_()
    y, h = ssm._ssd_chunked(tx, *(torch.from_numpy(v)
                                  for v in (bm, cm, dt, a)), cfg)
    assert y.shape == (2, t, nh, hp) and h.shape == (2, nh, hp, st)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)
    (y.sum() + h.sum()).backward()
    assert bool(torch.isfinite(tx.grad).all())
