"""Deterministic synthetic data -- counterpart of `repro.data.synthetic`.

Tokens are a pure function of (seed, step), so the pipeline is
resumable (a restore replays from the stored step with no iterator
state) and elastic (any device count reads the same global batch).  The
batch is drawn from a CPU `torch.Generator` seeded from (seed, step) and
then moved to the device, so the CPU and the card see the same bits.
The JAX package draws with ``jax.random``, which cannot be reproduced
without JAX: the token values differ from the JAX package's, their
ranges, shapes, dtypes and the ``markov`` recurrence do not.

Also the matrix generators of the logdet benchmarks (normal, scaled-SPD
"spatial correlation", and the paper's §2.2 adversarial rows), in numpy,
bit for bit the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.estimators.operators.base import resolve_device
from repro_torch.models.common import ModelConfig

__all__ = ["DataConfig", "synth_batch", "data_iterator", "random_matrix",
           "step_generator"]


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    kind: str = "lm"          # lm | markov


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose state is a function of (seed, step) only."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2 ** 63 - 1))


def synth_batch(cfg: ModelConfig, data: DataConfig, step: int, *,
                device=None) -> Dict[str, torch.Tensor]:
    """Global batch for ``step``, on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    g = step_generator(data.seed, step)
    b, t = data.batch, data.seq
    if data.kind == "markov":
        # a learnable stream: x_{t+1} = (31 x_t + 7 + noise) % vocab
        x = torch.randint(0, cfg.vocab, (b,), generator=g, dtype=torch.int64)
        noise = torch.randint(0, 17, (b, t), generator=g, dtype=torch.int64)
        cols = []
        for j in range(t):
            x = (x * 31 + 7 + noise[:, j]) % cfg.vocab
            cols.append(x)
        tokens = torch.stack(cols, dim=1)
    else:
        tokens = torch.randint(0, cfg.vocab, (b, t), generator=g,
                               dtype=torch.int64)
    tokens = tokens.to(torch.int32)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (b, cfg.enc_seq, cfg.d_model), generator=g,
            dtype=torch.float32).to(cfg.dtype)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(
            (b, cfg.n_img_tokens, cfg.d_model), generator=g,
            dtype=torch.float32).to(cfg.dtype)
    return {k: v.to(dev) for k, v in batch.items()}


def data_iterator(cfg: ModelConfig, data: DataConfig, start_step: int = 0,
                  *, device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synth_batch(cfg, data, step, device=device)
        step += 1


# ---------------------------------------------------------------------------
# matrices for the logdet core (paper §3 experiments)
# ---------------------------------------------------------------------------

def random_matrix(n: int, *, kind: str = "normal", seed: int = 0,
                  dtype=np.float64) -> np.ndarray:
    """Matrix families used by the paper + adversarial pivot cases."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((n, n)).astype(dtype)
    if kind == "spd":
        x = rng.standard_normal((n, n + 8))
        return ((x @ x.T) / n + 1e-3 * np.eye(n)).astype(dtype)
    if kind == "corr_scaled":
        # scaled spatial correlation matrix (paper §2.2's motivating case)
        x = rng.standard_normal((n, n + 8))
        c = (x @ x.T) / n + 1e-3 * np.eye(n)
        d = 1.0 / np.sqrt(np.diag(c))
        return (c * d[:, None] * d[None, :] * 1e-8).astype(dtype)
    if kind == "pivot_adversarial":
        # rows of {~1e-10, ~2.01}: closest-to-1 pivoting overflows (§2.2)
        a = np.where(rng.random((n, n)) < 0.5, 1e-10, 2.01)
        a += np.diag(rng.random(n) * 3.0)
        return a.astype(dtype)
    raise ValueError(kind)
