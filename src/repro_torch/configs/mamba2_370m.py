"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Sub-quadratic: runs long_500k (O(1)-state decode, chunked-scan prefill)."""
from repro_torch.models.common import ModelConfig

ARCH_ID = "mamba2-370m"
SKIP_SHAPES: set = set()  # sub-quadratic: runs everything incl. long_500k


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_conv=4, ssm_groups=1, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_headdim=16,
        ssm_chunk=16,
    )
