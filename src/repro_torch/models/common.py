"""Model config and shared layers -- counterpart of `repro.models.common`.

Every model module of the port follows one protocol: a block is an
``nn.Module`` whose parameters carry the JAX package's names and shapes
(``wq`` is (d, heads, head_dim) in both), created through `param` with
the JAX init rule, and whose ``forward`` mirrors the JAX ``*_apply``
arithmetic, including where JAX computes in f32 and casts back.  The
parameters of one model start from one explicit `torch.Generator`;
`repro_torch.models.convert.from_jax_params` loads the JAX package's own
numbers instead.

The JAX logical-axis recorder (``keygen`` / ``specs_of``,
`repro.models.common`) is not ported: nothing calls it (the sharding
rules resolve axes from a leaf's name, `repro_torch.sharding.rules`),
and ``specs_of(init_model, ...)`` raises ``TypeError`` on every arch
(its recording pass yields ``None`` keys, which ``_stack_init`` splits).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.sharding import tensor

__all__ = ["ModelConfig", "param", "ParamInit", "normal_init", "empty_init",
           "rmsnorm", "embed_lookup", "unembed", "rope_freqs", "apply_rope"]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | encdec | vlm | hybrid
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 512
    qkv_bias: bool = False
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # sliding-window pattern (gemma3): window size + one global layer every k
    sliding_window: int = 0        # 0 -> all layers full attention
    global_every: int = 0          # e.g. 6 -> layers 5, 11, ... are global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1             # 2 -> every 2nd layer is MoE (llama4)
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500            # whisper: 30s of audio -> 1500 frames
    # vision (llama-3.2-vision)
    cross_attn_every: int = 0      # e.g. 5 -> one cross-attn layer per 5
    n_img_tokens: int = 0
    # hybrid (zamba2)
    shared_attn_every: int = 0     # e.g. 6 -> shared attn block every 6 ssm
    # compute
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_impl: str = "full"        # full | chunked
    attn_chunk: int = 2048
    remat: bool = True
    scan_layers: bool = True       # the JAX scan/unroll switch: no meaning
                                   # here (layers are a Python loop)
    logits_softcap: float = 0.0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def nh_ssm(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_headdim)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Param creation
# ---------------------------------------------------------------------------

# (shape, dtype, scale or None for zeros) -> tensor
ParamInit = Callable[[tuple, torch.dtype, Optional[float]], torch.Tensor]


def param(init: ParamInit, shape, dtype, *, scale: float | None = None,
          zeros: bool = False) -> torch.nn.Parameter:
    """One parameter by the JAX package's rule: a standard normal times
    ``scale``, which defaults to ``1/sqrt(shape[0])`` for a matrix (any
    rank >= 2) and 0.02 for a vector; ``zeros`` (the JAX ``key=None``)
    gives zeros."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0]) if len(shape) >= 2 else 0.02
    return torch.nn.Parameter(init(tuple(shape), dtype,
                                   None if zeros else scale))


def normal_init(generator: torch.Generator, device) -> ParamInit:
    """Draws in f32 from ``generator`` (on its own device), scales, casts
    to the parameter's dtype and moves the result to ``device``: one
    generator and seed give the same numbers on the CPU and the card
    when the generator is on the CPU."""
    def init(shape, dtype, scale):
        if scale is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * scale).to(dtype).to(device)
    return init


def empty_init(device) -> ParamInit:
    """Uninitialized storage, for a model whose numbers are loaded next."""
    def init(shape, dtype, scale):
        return torch.empty(shape, dtype=dtype, device=device)
    return init


# ---------------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in f32 with a ``(1 + scale)`` gain, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype,
                 vocab: Optional[int] = None):
    """The rows of ``ids`` in ``dtype``.  Inside a model split
    (`repro_torch.sharding.tensor`) a ``table`` of fewer rows than
    ``vocab`` is this rank's block: it looks up the ids it holds, the
    others as zeros, and the ranks' rows are summed by
    `tensor.from_model` (one of them non-zero: exact)."""
    first = (None if vocab is None
             else tensor.share(table.shape[0], vocab, "vocab"))
    if first is None:
        return table[ids].to(dtype)
    at = ids - first
    mine = (at >= 0) & (at < table.shape[0])
    rows = table[torch.where(mine, at, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tensor.from_model(rows.to(dtype))


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *,
            softcap: float = 0.0, vocab: Optional[int] = None):
    """f32 logits (B, T, vocab), with the optional tanh softcap; inside a
    model split, from this rank's block of a vocab-parallel table, this
    rank's columns of them (``x`` through `tensor.to_model`)."""
    if vocab is not None and tensor.share(table_or_head.shape[0], vocab,
                                          "vocab") is not None:
        x = tensor.to_model(x)
    logits = torch.einsum("btd,vd->btv", x.float(), table_or_head.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) -> (sin, cos) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python base: no host-to-device copy (which would sync the card)
    inv = 1.0 / torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x (..., T, H, D); sin/cos (..., T, D/2) broadcast over heads.

    The rotation runs in f32 and the result is cast back to x's dtype.
    """
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    s = sin[..., None, :]
    c = cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
