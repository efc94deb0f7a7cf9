"""zamba2-7b [hybrid]: 81 Mamba2 layers, d_model=3584, + ONE shared
attention+MLP block (32H kv=32, d_ff=14336) applied every 6th position,
vocab=32000, ssm_state=64.  [arXiv:2411.15242; unverified]

Sub-quadratic backbone: runs long_500k (the shared attention block keeps a
KV cache per invocation — 13 caches of the single shared block)."""
from repro_torch.models.common import ModelConfig

ARCH_ID = "zamba2-7b"
SKIP_SHAPES: set = set()


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_conv=4, ssm_groups=1, shared_attn_every=6,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
        shared_attn_every=2,
    )
