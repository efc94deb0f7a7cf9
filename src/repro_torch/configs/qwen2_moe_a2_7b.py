"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) d_ff_expert=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=151936, qkv_bias=True, rope_theta=1e6,
        n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
        moe_every=1, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=32, vocab=256, n_experts=8, top_k=2, n_shared_experts=1,
        d_ff_expert=32,
    )
