"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
— 5:1 local:global sliding-window attention, 128k rope, head_dim=256.
[hf:google/gemma-3-1b-pt; unverified]

long_500k RUNS for this arch: 5/6 of its layers are 512-token sliding-window
(sub-quadratic); only every 6th layer is global."""
from repro_torch.models.common import ModelConfig

ARCH_ID = "gemma3-1b"
SKIP_SHAPES: set = set()


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144, rope_theta=1e6,
        sliding_window=512, global_every=6,
        tie_embeddings=True, logits_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8, global_every=3,
    )
