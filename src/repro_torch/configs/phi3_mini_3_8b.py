"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "phi3-mini-3.8b"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab=32064, rope_theta=10000.0,
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
    )
