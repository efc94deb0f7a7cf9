"""whisper-tiny [audio enc-dec]: 4L enc + 4L dec, d_model=384 6H (MHA kv=6)
d_ff=1536 vocab=51865 — conv audio frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, 1500, d_model).  [arXiv:2212.04356; unverified]
"""
from repro_torch.models.common import ModelConfig

ARCH_ID = "whisper-tiny"
SKIP_SHAPES = {"long_500k"}


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        n_layers=4, n_enc_layers=4, enc_seq=1500,
        d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab=51865, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, n_enc_layers=2, enc_seq=16, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
    )
