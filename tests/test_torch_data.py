"""`repro_torch.data` against `repro.data`: ``random_matrix`` bit for bit
for every kind, through the port's exact plan against numpy; and
``synth_batch``, whose values differ from the JAX package's (torch and
jax.random draw other numbers) but whose shapes, dtypes, ranges, rolled
targets and ``markov`` recurrence are the JAX package's, as a pure
function of (seed, step)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as jax_config
from repro.data import synthetic as jsyn

import repro_torch
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, data_iterator, random_matrix, \
    synth_batch
from repro_torch.data.synthetic import step_generator

KINDS = ["normal", "spd", "corr_scaled", "pivot_adversarial"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_random_matrix_bitwise_jax(kind, seed, dtype):
    for n in (1, 17, 64):
        got = random_matrix(n, kind=kind, seed=seed, dtype=dtype)
        want = jsyn.random_matrix(n, kind=kind, seed=seed, dtype=dtype)
        assert got.dtype == want.dtype and got.shape == (n, n)
        np.testing.assert_array_equal(got, want)


def test_random_matrix_unknown_kind_raises_as_jax():
    with pytest.raises(ValueError):
        jsyn.random_matrix(4, kind="banded")
    with pytest.raises(ValueError):
        random_matrix(4, kind="banded")


@pytest.mark.parametrize("update", ["rank1", "panel"])
@pytest.mark.parametrize("kind", KINDS)
def test_random_matrix_through_the_exact_plan(kind, update):
    """Each kind at N = 96 f64 through the port's exact plan on the CPU:
    sign equal to numpy's slogdet, log|det| within 1e-9 x max(1, |ref|)
    (the card runs this at N = 2048 in chip_smoke.py phase 13)."""
    a = random_matrix(96, kind=kind, seed=0)
    s_ref, ld_ref = np.linalg.slogdet(a)
    res = repro_torch.plan(torch.from_numpy(a), method="exact",
                           update=update, k=16, device="cpu")()
    assert float(res.sign) == s_ref
    assert abs(float(res.logabsdet) - ld_ref) <= 1e-9 * max(1.0, abs(ld_ref))


DATA = [DataConfig(seed=0, batch=3, seq=12, kind="lm"),
        DataConfig(seed=5, batch=2, seq=20, kind="markov")]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-tiny",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("data", DATA, ids=["lm", "markov"])
def test_synth_batch_keys_shapes_dtypes_equal_jax(data, arch):
    cfg = get_config(arch, smoke=True)
    jb = jsyn.synth_batch(jax_config(arch, smoke=True), data, 0)
    tb = synth_batch(cfg, data, 0, device="cpu")
    assert list(tb) == list(jb)
    for k, v in tb.items():
        assert tuple(v.shape) == jb[k].shape, k
        assert str(v.dtype).replace("torch.", "") == jnp.dtype(
            jb[k].dtype).name, k
        assert v.device.type == "cpu"


@pytest.mark.parametrize("data", DATA, ids=["lm", "markov"])
def test_synth_batch_is_a_pure_function_of_seed_and_step(data):
    cfg = get_config("whisper-tiny", smoke=True)
    a = synth_batch(cfg, data, 7, device="cpu")
    b = synth_batch(cfg, data, 7, device="cpu")
    c = synth_batch(cfg, data, 8, device="cpu")
    d = synth_batch(cfg, DataConfig(seed=data.seed + 1, batch=data.batch,
                                    seq=data.seq, kind=data.kind), 7,
                    device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert not torch.equal(a["frames"], c["frames"])
    it = data_iterator(cfg, data, start_step=6, device="cpu")
    for step in (6, 7, 8):
        got = next(it)
        want = synth_batch(cfg, data, step, device="cpu")
        assert all(torch.equal(got[k], want[k]) for k in got)
    # the generator's state is the (seed, step) pair's alone
    assert torch.equal(step_generator(1, 2).get_state(),
                       step_generator(1, 2).get_state())
    assert not torch.equal(step_generator(1, 2).get_state(),
                           step_generator(2, 1).get_state())


@pytest.mark.parametrize("data", DATA, ids=["lm", "markov"])
def test_synth_batch_range_and_rolled_targets(data):
    cfg = get_config("qwen2.5-3b", smoke=True)
    for step in range(3):
        b = synth_batch(cfg, data, step, device="cpu")
        tok = b["tokens"]
        assert tok.dtype == torch.int32 and tok.shape == (data.batch,
                                                          data.seq)
        assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab
        assert torch.equal(b["targets"], torch.roll(tok, -1, dims=1))
        assert torch.equal(b["targets"][:, -1], tok[:, 0])


def test_markov_follows_its_recurrence():
    """x' = (31 x + 7 + n) % vocab with n in [0, 17): every step of every
    row, and all 17 noise values appear."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    tok = synth_batch(cfg, DATA[1], 0, device="cpu")["tokens"].long()
    noise = (tok[:, 1:] - 31 * tok[:, :-1] - 7) % cfg.vocab
    assert int(noise.min()) >= 0 and int(noise.max()) < 17
    tok = synth_batch(cfg, DataConfig(seed=1, batch=8, seq=256,
                                      kind="markov"), 0,
                      device="cpu")["tokens"].long()
    noise = (tok[:, 1:] - 31 * tok[:, :-1] - 7) % cfg.vocab
    assert set(noise.unique().tolist()) == set(range(17))
    # the lm kind follows no such recurrence
    lm = synth_batch(cfg, DataConfig(seed=1, batch=8, seq=256), 0,
                     device="cpu")["tokens"].long()
    assert int(((lm[:, 1:] - 31 * lm[:, :-1] - 7) % cfg.vocab).max()) >= 17


def test_synth_batch_extras_in_the_config_dtype():
    """frames / img_embeds are standard normal draws in cfg.dtype (bf16
    at the smoke configs, as in the JAX package)."""
    for arch, key in (("whisper-tiny", "frames"),
                      ("llama-3.2-vision-11b", "img_embeds")):
        cfg = get_config(arch, smoke=True)
        x = synth_batch(cfg, DataConfig(batch=4, seq=8), 0,
                        device="cpu")[key]
        assert x.dtype == cfg.dtype == torch.bfloat16
        assert abs(float(x.float().std()) - 1.0) < 0.1
