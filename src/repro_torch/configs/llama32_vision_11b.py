"""llama-3.2-vision-11b [vlm]: 40L total (32 self + 8 gated cross-attn,
one cross layer per 5) d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
The vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, n_img_tokens, d_model).  [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "llama-3.2-vision-11b"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256, rope_theta=5e5,
        cross_attn_every=5, n_img_tokens=1600, tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, cross_attn_every=2, n_img_tokens=8,
    )
