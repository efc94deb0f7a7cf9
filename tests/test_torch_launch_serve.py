"""CPU twins of `repro_torch.launch.serve` against `repro.launch.serve`.

`generate` on the JAX parameters carried across (`from_jax_params`),
f32 activations, a (2, 8) prompt and 4 generated tokens, for mamba2-370m
(the JAX launcher test's arch), a dense arch and whisper-tiny (the
encoder-decoder extras: each package's encoder on the same frames).
The logits the port's `generate` computed (recorded from its prefill
and decode steps) are held within LOGIT_TOL of the JAX package's
prefill and decode steps fed the same tokens, and the greedy tokens
equal JAX `generate`'s up to the first position whose top-2 logit margin
is within twice that tolerance.  The CLI returns (2, 12) on the CPU; the
masked decode write of the ``kv_masked_write`` hint writes the same
bits as ``index_copy_``."""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch import serve as JS
from repro.models import model as JM

from repro_torch.configs import get_config
from repro_torch.launch import serve as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.sharding import hints

LOGIT_TOL = 1e-4                      # of max(1, |logits|)
B, T0, GEN = 2, 8, 4
ARCHS = ["mamba2-370m", "qwen2.5-3b", "whisper-tiny"]


def _setup(arch):
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32,
                                                remat=False)
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                               remat=False)
    params = jax.jit(lambda k: JM.init_model(k, jcfg))(jax.random.PRNGKey(0))
    model = from_jax_params(jax.device_get(params), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (B, T0)).astype(np.int32)
    jextras = extras = None
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
            np.float32)
        jextras = {"memory": JM._encode(params, {"frames": jnp.asarray(
            frames)}, jcfg)}
        with torch.no_grad():
            extras = {"memory": M._encode(model, {"frames": torch.from_numpy(
                frames)})}
    return jcfg, params, model, prompt, jextras, extras


def _jax_logits(jcfg, params, prompt, toks, jextras):
    """The JAX package's prefill + decode logits along ``toks``."""
    batch = dict(jextras or {})
    batch["tokens"] = jnp.asarray(prompt)
    lg, caches = JM.prefill(params, batch, jcfg, T0 + GEN)
    out = [np.asarray(lg[:, -1])]
    for i, pos in enumerate(range(T0, T0 + GEN - 1)):
        tok = jnp.asarray(toks[:, T0 + i:T0 + i + 1])
        lg, caches = JM.decode_step(params, tok, caches, pos, jcfg,
                                    batch_extras=jextras)
        out.append(np.asarray(lg[:, -1]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_jax_launcher(arch, monkeypatch):
    jcfg, params, model, prompt, jextras, extras = _setup(arch)
    seen = []
    prefill, decode = M.prefill, M.decode_step

    def rec_prefill(*a, **k):
        lg, c = prefill(*a, **k)
        seen.append(lg[:, -1].numpy().copy())
        return lg, c

    def rec_decode(*a, **k):
        lg, c = decode(*a, **k)
        seen.append(lg[:, -1].numpy().copy())
        return lg, c
    monkeypatch.setattr(M, "prefill", rec_prefill)
    monkeypatch.setattr(M, "decode_step", rec_decode)
    toks = S.generate(model, torch.from_numpy(prompt), max_len=T0 + GEN,
                      gen=GEN, extras=extras).numpy()
    assert toks.shape == (B, T0 + GEN) and toks.dtype == np.int32
    assert (toks[:, :T0] == prompt).all()
    jtoks = np.asarray(JS.generate(params, jcfg, jnp.asarray(prompt),
                                   max_len=T0 + GEN, gen=GEN,
                                   extras=jextras))
    want = _jax_logits(jcfg, params, prompt, toks, jextras)
    assert len(seen) == len(want) == GEN
    for i, (g, w) in enumerate(zip(seen, want)):
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= LOGIT_TOL * scale, (arch, i)
    # greedy tokens: equal until a near tie of the top two logits
    for i, w in enumerate(want):
        top2 = np.sort(w, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= 2 * LOGIT_TOL * max(
                1.0, float(np.abs(w).max())):
            break
        assert (toks[:, T0 + i] == jtoks[:, T0 + i]).all(), (arch, i)
        assert (toks[:, T0 + i] == w.argmax(-1)).all()
    else:
        assert (toks == jtoks).all()


def test_sampling_takes_the_generator():
    cfg = get_config("qwen2.5-3b", smoke=True).replace(remat=False)
    model = M.init_model(cfg, device="cpu")
    prompt = torch.zeros((B, T0), dtype=torch.int32)

    def run(seed):
        return S.generate(model, prompt, max_len=T0 + 8, gen=8,
                          temperature=0.8,
                          generator=torch.Generator().manual_seed(seed))
    a, b = run(1), run(1)
    assert torch.equal(a, b) and a.shape == (B, T0 + 8)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    assert not torch.equal(run(1), run(2))


def test_serve_cli_on_the_cpu(capsys):
    toks = S.main(["--arch", "mamba2-370m", "--batch", "2", "--prompt-len",
                   "8", "--gen", "4", "--device", "cpu"])
    assert tuple(toks.shape) == (2, 12)
    out = capsys.readouterr().out
    assert "mamba2-370m: generated 2x4 tokens in" in out
    assert "sample:" in out


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-7b", "whisper-tiny"])
def test_masked_decode_write_is_index_copy(arch):
    """Under ``hints.configure(..., kv_masked_write=True)`` the decode
    step writes the caches by a one-hot merge: the same bits, and the
    same logits, as the indexed write."""
    cfg = get_config(arch, smoke=True).replace(remat=False)
    model = M.init_model(cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, T0)).astype(np.int32))}
    extras = None
    if cfg.family == "encdec":
        with torch.no_grad():
            extras = {"memory": M._encode(model, {"frames": torch.from_numpy(
                rng.standard_normal((B, cfg.enc_seq, cfg.d_model))).to(
                    cfg.dtype)})}
        batch.update(extras)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(
        np.int32))
    outs = []
    for masked in (False, True):
        with torch.no_grad():
            _, caches = M.prefill(model, batch, T0 + 4)
            try:
                hints.configure(cfg, make_production_mesh(),
                                kv_masked_write=masked)
                assert hints.flag("kv_masked_write") == masked
                lg, caches = M.decode_step(model, tok, caches, T0,
                                           batch_extras=extras)
                lg, caches = M.decode_step(model, tok, caches, T0 + 1,
                                           batch_extras=extras)
            finally:
                hints.configure(cfg, None)
        outs.append((lg, jax.tree.leaves(caches)))
    (la, ca), (lb, cb) = outs
    assert torch.equal(la, lb)
    assert len(ca) == len(cb) > 0
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
