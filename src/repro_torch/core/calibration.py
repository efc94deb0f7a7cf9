"""Measured-roofline calibration for the port's method/route selector.

Counterpart of `repro.core.calibration`: the same table terms and the
same cost functions, which `repro_torch.core.plan.select_route` prices
routes with,

  gemm_flops        sustained rate of the rank-K trailing update (K2),
                    FLOP/s -- prices panel updates and estimator slabs
  stream_bytes      sustained streaming rate of the rank-1 update (K1),
                    bytes/s
  collective_lat    per-collective latency (s) of the mesh's broadcast
  collective_bytes  collective payload bandwidth (bytes/s)

plus the one term the JAX model lacks, the **host dispatch** of the exact
routes:

  host_rank1_row_s  host time per eliminated row of a rank-1 route
  host_panel_row_s  host time per eliminated row of a panel route

On the card an exact route is paced by the host, which enqueues a few
dozen small PyTorch operations around every kernel launch, not by the
kernels' FLOPs and bytes; `exact_cost` adds ``n * host_<update>_row_s``
to every exact route (the mesh routes too: each rank loops over all n
rows; a (B, n, n) stack too, whose every step runs all B matrices at once
in the same few operations and launches).  Both default to 0, and a table in the JAX package's format has
neither, so on such a table every cost here equals the JAX package's.

The table is written by ``python3 tools/torch_calibrate.py`` on the card.
Search order: ``$REPRO_TORCH_CALIBRATION`` (a path, or ``static`` for the
built-in defaults), then the committed
``bench_out/torch_roofline_calibration.json``, then the static defaults.
The JAX package's table (``bench_out/roofline_calibration.json``, measured
on a CPU) is read only when its path is passed.
"""
from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

__all__ = [
    "Calibration", "STATIC_DEFAULT", "load_calibration",
    "clear_calibration_cache", "calibration_path", "exact_cost",
    "estimator_cost",
]

_ENV_VAR = "REPRO_TORCH_CALIBRATION"
_TABLE_NAME = "torch_roofline_calibration.json"
# probes per matvec slab the estimators batch into one pass (make_probes
# default) -- sets how many sequential collectives an estimator run needs
_EST_SLAB = 32
# modeled bf16:native GEMM throughput ratio when a table carries no
# measured bf16 entry
_BF16_GEMM_SPEEDUP = 2.0


@dataclass(frozen=True)
class Calibration:
    """Per-device roofline terms and host terms; see the module docstring.

    ``gemm_flops_bf16`` is the optional measured rate with bf16 operands;
    absent, `gemm_rate` models it as ``_BF16_GEMM_SPEEDUP x gemm_flops``.
    """
    gemm_flops: float = 4.0e10
    stream_bytes: float = 1.5e10
    collective_lat: float = 2.0e-5
    collective_bytes: float = 4.0e9
    source: str = "static-default"
    gemm_flops_bf16: Optional[float] = None
    host_rank1_row_s: float = 0.0
    host_panel_row_s: float = 0.0

    def __post_init__(self):
        for name in ("gemm_flops", "stream_bytes", "collective_lat",
                     "collective_bytes"):
            v = float(getattr(self, name))
            if not v > 0:
                raise ValueError(f"calibration {name} must be > 0, got {v}")
        if self.gemm_flops_bf16 is not None \
                and not float(self.gemm_flops_bf16) > 0:
            raise ValueError(
                f"calibration gemm_flops_bf16 must be > 0, "
                f"got {self.gemm_flops_bf16}")
        for name in ("host_rank1_row_s", "host_panel_row_s"):
            v = float(getattr(self, name))
            if not v >= 0:
                raise ValueError(f"calibration {name} must be >= 0, got {v}")

    def gemm_rate(self, precision: Optional[str] = None) -> float:
        """Sustained GEMM FLOP/s for an engine precision route."""
        if precision in (None, "f32", "f64", "native"):
            return float(self.gemm_flops)
        if precision == "bf16":
            if self.gemm_flops_bf16 is not None:
                return float(self.gemm_flops_bf16)
            return float(self.gemm_flops) * _BF16_GEMM_SPEEDUP
        raise ValueError(f"unknown precision {precision!r}")

    def host_row_s(self, update: str) -> float:
        """Host time per eliminated row of an ``update`` route."""
        return float(self.host_panel_row_s if update == "panel"
                     else self.host_rank1_row_s)


STATIC_DEFAULT = Calibration()


def calibration_path() -> Optional[Path]:
    """Where a measured table would be loaded from (None -> static)."""
    env = os.environ.get(_ENV_VAR, "").strip()
    if env:
        if env.lower() == "static":
            return None
        return Path(env)
    committed = Path(__file__).resolve().parents[3] / "bench_out" / _TABLE_NAME
    return committed if committed.exists() else None


@functools.lru_cache(maxsize=8)
def _load(path_str: Optional[str]) -> Calibration:
    if path_str is None:
        return STATIC_DEFAULT
    try:
        raw = json.loads(Path(path_str).read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"cannot read calibration table {path_str}: {e}")
    bf16 = raw.get("bf16") or {}
    bf16_rate = bf16.get("gemm_flops", raw.get("gemm_flops_bf16"))
    return Calibration(
        gemm_flops=float(raw["gemm_flops"]),
        stream_bytes=float(raw["stream_bytes"]),
        collective_lat=float(raw["collective_lat"]),
        collective_bytes=float(raw["collective_bytes"]),
        source=str(raw.get("source", f"measured:{path_str}")),
        gemm_flops_bf16=None if bf16_rate is None else float(bf16_rate),
        host_rank1_row_s=float(raw.get("host_rank1_row_s", 0.0)),
        host_panel_row_s=float(raw.get("host_panel_row_s", 0.0)),
    )


def load_calibration(path=None) -> Calibration:
    """The active calibration table (measured if available)."""
    if path is not None:
        return _load(str(path))
    p = calibration_path()
    return _load(None if p is None else str(p))


def clear_calibration_cache():
    """Re-read tables on next load (test hook / after re-calibration)."""
    _load.cache_clear()


# --------------------------------------------------------------------------
# route cost model (seconds)
# --------------------------------------------------------------------------

def exact_cost(n: int, devices: int, cal: Calibration, *,
               update: str = "rank1", panel_k: Optional[int] = None,
               itemsize: int = 8, batch: int = 1,
               lookahead: bool = False,
               precision: Optional[str] = None) -> float:
    """Modeled wall time of an exact condensation route.

    The JAX package's model (`repro.core.calibration.exact_cost`: the
    compute term split over ``devices``, a mesh's per-step collectives
    not split, lookahead hiding the collectives behind the bulk update),
    plus the host's dispatch, ``n * cal.host_row_s(update)``, which no
    device count divides (every rank runs the loop over all n rows) and
    no stack multiplies: a stack's step runs all B matrices at once, in
    the operations and launches of one matrix's step
    (``tools/torch_calibrate.py`` times a stack route beside one matrix
    of the same side on the card).

    ``panel_k=None`` resolves through the tile autotuner
    (`repro_torch.kernels.autotune`).
    """
    if n <= 1:
        return 0.0
    if panel_k is None:
        from repro_torch.kernels.autotune import resolved_panel_k
        panel_k = resolved_panel_k(n, itemsize=itemsize,
                                   precision=precision, cal=cal)
    flops = (2.0 / 3.0) * float(n) ** 3
    if update == "panel":
        # rank-K trailing updates are GEMMs
        compute = flops / cal.gemm_rate(precision)
    else:
        # rank-1 updates stream the live block once per step: with staged
        # scheduling ~ itemsize * n^3 bytes end to end
        compute = itemsize * float(n) ** 3 / cal.stream_bytes
    cost = batch * compute / devices
    if devices > 1:
        if update == "panel":
            steps = max(1, n // panel_k)
            payload = itemsize * panel_k * n          # (K x N) panel + ls
            width = panel_k
        else:
            steps = n
            payload = itemsize * n                    # one normalized row
            width = 1
        # tree collectives pay the latency once per hop: ~log2(P) depth
        lat = cal.collective_lat * max(1.0, math.log2(devices))
        comm = steps * (lat + payload / cal.collective_bytes)
        if lookahead:
            # the in-flight collective overlaps the bulk update: only the
            # part of comm that exceeds per-device compute stays exposed
            hidden = min(comm, cost)
            overhead = steps * 2.0 * width * width * n / cal.gemm_flops
            cost += (comm - hidden) + overhead
        else:
            cost += comm
    return cost + n * cal.host_row_s(update)


def estimator_cost(n: int, cols: int, matvec_flops: float, devices: int,
                   cal: Calibration, *, itemsize: int = 8,
                   batch: int = 1) -> float:
    """Modeled wall time of a stochastic estimator run.

    ``cols`` is the probe x step budget (total matvec columns), priced on
    the GEMM rate; on a mesh the row-sharded product pays one collective
    per slab of `_EST_SLAB` columns.
    """
    compute = batch * cols * matvec_flops / (devices * cal.gemm_flops)
    cost = compute
    if devices > 1:
        seq = max(1, cols // _EST_SLAB)
        payload = itemsize * n * _EST_SLAB
        cost += seq * (cal.collective_lat + payload / cal.collective_bytes)
    return cost
