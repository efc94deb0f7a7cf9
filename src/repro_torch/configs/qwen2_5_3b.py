"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen2.5-3b"
SKIP_SHAPES = {"long_500k"}      # pure full attention -> no sub-quadratic path


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
    )
