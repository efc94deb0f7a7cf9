"""Calibration-driven panel width for the condensation engine.

Counterpart of `repro.kernels.autotune`: the panel width ``k`` of the
rank-K update is the candidate that minimizes the same modeled time
(`_model_cost`: the trailing GEMMs, one pass over the trailing block per
panel, and the panel factorizations' k passes over each panel), so
``method="auto"`` runs the width `core.calibration.exact_cost` priced.

Where the JAX package reports Pallas block sizes sized to TPU vector
registers, ``block_m`` / ``block_n`` here are the output tile that K2
(``csrc/panel_update.cu``) really uses for the buffer and operand dtypes;
K2 takes no tile from Python, so they are informational.

Results are cached per (device fingerprint, dtype, n-bucket, calibration
source).  ``REPRO_AUTOTUNE`` overrides, as in the JAX package:

  REPRO_AUTOTUNE=off                      pin the legacy width 32
  REPRO_AUTOTUNE=panel_k=64               pin the panel width
  REPRO_AUTOTUNE=panel_k=64,block_m=128,block_n=256
                                          pin width and reported tile
"""
from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass

__all__ = [
    "TileConfig", "tile_config", "resolved_panel_k", "device_fingerprint",
    "clear_autotune_cache", "DEFAULT_PANEL_K", "PANEL_K_CANDIDATES",
]

_ENV_VAR = "REPRO_AUTOTUNE"

# the legacy fixed geometry (pre-autotuner); REPRO_AUTOTUNE=off pins it
DEFAULT_PANEL_K = 32
PANEL_K_CANDIDATES = (8, 16, 32, 64, 128)

# K2's output tile (BM, BN) by buffer itemsize and operand precision: the
# `Config<T, OpT>` lines of csrc/panel_update.cu (BM = 16 TM, BN = 16 x
# (16-byte vectors of T) x J)
_BLOCKS = {(4, None): (64, 128), (4, "bf16"): (128, 128),
           (8, None): (64, 64), (8, "bf16"): (64, 64)}
_DEFAULT_BLOCKS = _BLOCKS[4, None]


@dataclass(frozen=True)
class TileConfig:
    """A resolved geometry.

    ``panel_k``  rank-K panel width (engine ``panel`` update / exact_cost).
    ``block_m`` / ``block_n``  K2's output tile for this dtype.
    ``source``   provenance: "model:<cal-source>", "env", or "off".
    """
    panel_k: int = DEFAULT_PANEL_K
    block_m: int = _DEFAULT_BLOCKS[0]
    block_n: int = _DEFAULT_BLOCKS[1]
    source: str = "off"

    def __post_init__(self):
        for name in ("panel_k", "block_m", "block_n"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")


@functools.lru_cache(maxsize=1)
def device_fingerprint() -> str:
    """Stable id of the device the tuned geometry was derived for."""
    import torch
    if torch.cuda.is_available():
        return (f"cuda:{torch.cuda.get_device_name(0)}:"
                f"{torch.cuda.device_count()}")
    return "cpu"


def _parse_override(env: str):
    """Parse a REPRO_AUTOTUNE override; None means "run the model"."""
    env = env.strip()
    if not env:
        return None
    if env.lower() == "off":
        return TileConfig(source="off")
    fields = {}
    for part in env.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad {_ENV_VAR} entry {part!r}; expected 'off' or "
                "comma-separated key=int pairs "
                "(panel_k=..., block_m=..., block_n=...)")
        key, _, val = part.partition("=")
        key = key.strip()
        if key not in ("panel_k", "block_m", "block_n"):
            raise ValueError(f"unknown {_ENV_VAR} key {key!r}; one of "
                             "panel_k, block_m, block_n")
        fields[key] = int(val)
    return TileConfig(source="env", **{
        "block_m": _DEFAULT_BLOCKS[0], "block_n": _DEFAULT_BLOCKS[1],
        **fields})


def _model_cost(k: int, n: int, itemsize: int, gemm: float,
                stream: float) -> float:
    """Modeled seconds for one n x n condensation at panel width k.

    gemm term    (2/3) n^3 trailing-update FLOPs at the measured rate
    stream terms one fused swap+update pass over the trailing block per
                 panel (~n^2 elements x n/k panels) plus the k serial
                 rank-1 passes of each panel factorization (k x n panel
                 re-streamed k times => k * n^2 total elements)
    """
    panels = max(1.0, n / k)
    gemm_t = (2.0 / 3.0) * float(n) ** 3 / gemm
    byte_t = itemsize / stream
    sweep_t = panels * 0.5 * float(n) ** 2 * 2.0 * byte_t
    factor_t = float(k) * float(n) ** 2 * byte_t
    return gemm_t + sweep_t + factor_t


def _model(n_bucket: int, itemsize: int, precision, cal) -> TileConfig:
    gemm = float(cal.gemm_rate(precision))
    stream = float(cal.stream_bytes)
    cap = max(PANEL_K_CANDIDATES[0], n_bucket // 4)
    cands = [k for k in PANEL_K_CANDIDATES if k <= cap] \
        or [PANEL_K_CANDIDATES[0]]
    best = min(cands, key=lambda k: _model_cost(k, n_bucket, itemsize,
                                                gemm, stream))
    bm, bn = _BLOCKS.get((itemsize, precision), _DEFAULT_BLOCKS)
    return TileConfig(panel_k=best, block_m=bm, block_n=bn,
                      source=f"model:{cal.source}")


@functools.lru_cache(maxsize=64)
def _tuned(fingerprint: str, n_bucket: int, itemsize: int,
           precision, cal_key: str) -> TileConfig:
    from repro_torch.core.calibration import load_calibration
    return _model(n_bucket, itemsize, precision, load_calibration())


def tile_config(n: int, *, itemsize: int = 4, precision=None,
                cal=None) -> TileConfig:
    """The tuned geometry for an ``n x n`` problem on this device.

    ``itemsize`` is the buffer dtype's width in bytes; ``precision`` the
    engine's mixed-precision route (``"bf16"`` prices GEMM operands at the
    bf16 rate).  ``cal`` overrides the loaded calibration table (tests);
    the override bypasses the cache.
    """
    override = _parse_override(os.environ.get(_ENV_VAR, ""))
    if override is not None:
        return override
    n_bucket = 1 << max(3, int(math.ceil(math.log2(max(2, int(n))))))
    if cal is not None:
        return _model(n_bucket, int(itemsize), precision, cal)
    from repro_torch.core.calibration import load_calibration
    return _tuned(device_fingerprint(), n_bucket, int(itemsize), precision,
                  load_calibration().source)


def resolved_panel_k(n: int, *, itemsize: int = 4, precision=None,
                     cal=None) -> int:
    """The tuned panel width (what replaced the hard-coded 32)."""
    return tile_config(n, itemsize=itemsize, precision=precision,
                       cal=cal).panel_k


def clear_autotune_cache():
    """Re-run the model on next call (test hook / after recalibration)."""
    _tuned.cache_clear()
    device_fingerprint.cache_clear()
