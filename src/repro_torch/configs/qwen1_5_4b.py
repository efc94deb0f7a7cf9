"""qwen1.5-4b [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen1.5-4b"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
        d_ff=6912, vocab=151936, qkv_bias=True, rope_theta=5e6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
    )
