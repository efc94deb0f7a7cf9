"""The input-shape set (the same four cells for every LM-family arch).

  train_4k      seq 4096  x global_batch 256   -> train_step
  prefill_32k   seq 32768 x global_batch 32    -> prefill
  decode_32k    seq 32768 x global_batch 128   -> serve_step (1 new token,
                                                  KV cache of 32768)
  long_500k     seq 524288 x global_batch 1    -> serve_step; ONLY for
                sub-quadratic archs (ssm/hybrid/sliding-window); pure
                full-attention archs skip it
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SHAPE_NAMES = tuple(SHAPES)
