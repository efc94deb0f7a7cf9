"""The port's dense archs against the JAX package at the smoke configs:
qwen2.5 (GQA, QKV bias), qwen1.5 (MHA, QKV bias), gemma3 (sliding window
with every 3rd layer global, softcap, kv = 1) and phi3 (untied head).
The shared checks are tests/_torch_model_twins.py's; the chunked
(online-softmax) attention is held here against the JAX one."""
import numpy as np
import pytest

import jax
import torch

from repro.models import model as JM

import _torch_model_twins as T
from repro_torch.models import model as M

ARCHS = ["qwen2.5-3b", "qwen1.5-4b", "gemma3-1b", "phi3-mini-3.8b"]
twins = T.twin_fixture(ARCHS)


@pytest.mark.parametrize("check", sorted(T.CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_twin(twins, arch, check):
    T.CHECKS[check](twins(arch))


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_chunked_attention_matches_jax_and_full(twins, arch):
    """attn_impl="chunked" with 4-token chunks over 10 tokens (a padded
    last chunk; gemma3's 8-token window crosses chunks): the port's
    forward equals JAX's chunked forward within 1e-4 and the port's own
    full attention within 1e-5; its gradient flows (each chunk is
    recomputed in the backward)."""
    twin = twins(arch)
    jcfg, cfg = T.configs(arch, remat=False, attn_impl="chunked",
                          attn_chunk=4)
    batch = T.make_batch(cfg, 2, 10, np.random.default_rng(3))
    want, _ = jax.jit(lambda p, b: JM.forward(p, b, jcfg))(
        twin.params, T.to_jax(batch))
    model = twin.model(cfg)
    logits, _ = M.forward(model, T.to_torch(batch))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=T.FWD_RTOL, atol=T.FWD_ATOL)
    with torch.no_grad():
        full, _ = M.forward(twin.model(), T.to_torch(batch))
    np.testing.assert_allclose(logits.detach().numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    logits.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
