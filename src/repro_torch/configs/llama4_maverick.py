"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, interleaved every 2nd layer,
1 shared expert.  [hf:meta-llama/Llama-4 family; unverified]

Config note: the flat numbers (MoE in
all 48 layers) would give ~773B total; the released Maverick interleaves MoE
every 2nd layer with one shared expert, which lands at ~400B total / ~17B
active — we implement that interpretation (moe_every=2, n_shared_experts=1).
"""
import torch

from repro_torch.models.common import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048, rope_theta=5e5,
        n_experts=128, top_k=1, n_shared_experts=1, d_ff_expert=8192,
        moe_every=2, tie_embeddings=False,
        # 400B on 256 x 16GB chips: bf16 weights (+ Adafactor f32 factored
        # slots, PaLM-style) — f32 master weights alone would be 6.4 GB/chip
        param_dtype=torch.bfloat16,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_experts=8, d_ff_expert=32, moe_every=2,
    )
