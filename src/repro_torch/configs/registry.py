"""Arch registry + input_specs -- counterpart of `repro.configs.registry`.

``input_specs(cfg, shape)`` returns the batch dict a step function takes,
as tensors on the meta device: shapes and dtypes, no storage (the JAX
package returns ``jax.ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.shapes import SHAPES
from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCHS = tuple(_MODULES)


def arch_ids():
    return ARCHS


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.smoke() if smoke else mod.full()


def skip_shapes(arch: str) -> set:
    return set(_module(arch).SKIP_SHAPES)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *, kind: str) -> Dict:
    """Meta tensors of the model-input batch dict."""
    tok = torch.int32
    specs: Dict = {}
    if kind == "train":
        specs["tokens"] = _meta((batch, seq), tok)
        specs["targets"] = _meta((batch, seq), tok)
    elif kind == "prefill":
        specs["tokens"] = _meta((batch, seq), tok)
    elif kind == "decode":
        specs["tokens"] = _meta((batch, 1), tok)
    else:
        raise ValueError(kind)

    if cfg.family == "encdec":
        if kind == "decode":
            specs["memory"] = _meta((batch, cfg.enc_seq, cfg.d_model),
                                    cfg.dtype)
        else:
            specs["frames"] = _meta((batch, cfg.enc_seq, cfg.d_model),
                                    cfg.dtype)
    if cfg.family == "vlm":
        specs["img_embeds"] = _meta((batch, cfg.n_img_tokens, cfg.d_model),
                                    cfg.dtype)
    return specs


def input_specs(arch_or_cfg, shape_name: str, *, smoke: bool = False):
    """(cfg, shape, batch-dict specs) for one (arch, shape) cell."""
    if isinstance(arch_or_cfg, ModelConfig):
        cfg = arch_or_cfg
    else:
        cfg = get_config(arch_or_cfg, smoke=smoke)
    shape = SHAPES[shape_name]
    specs = batch_specs(cfg, shape.global_batch, shape.seq_len, kind=shape.kind)
    return cfg, shape, specs
