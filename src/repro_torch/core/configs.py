"""Typed configuration of the exact family for `repro_torch.plan`.

Counterpart of `repro.core.configs`, exact family only: `ExactConfig`
keeps the JAX package's fields and validation, so one dict describes a
route in both packages.  `from_jax_config` carries a resolved JAX plan's
config across (the matrix itself crosses as a numpy array).

The estimator configs wait for their port (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.engine import (
    EngineConfig, SCHEDULES as _ENGINE_SCHEDULES, UPDATES as _ENGINE_UPDATES,
)

__all__ = ["ExactConfig", "EngineConfig", "config_for", "config_to_dict",
           "config_from_dict", "from_jax_config"]

# the JAX package's kernel backends; the port accepts them only in a dict
# carried across by `from_jax_config`, where each maps to "auto"
_JAX_BACKENDS = ("auto", "xla", "pallas", "interpret")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class ExactConfig:
    """Knobs of the exact condensation engine (``method="exact"``).

    ``schedule`` -- "serial" | "staged" ("mesh": not ported yet); ``None``
                   resolves to "staged" at plan time.
    ``update``   -- "rank1" | "panel"; ``None`` resolves to "rank1".
    ``backend``  -- "auto" only: the kernel follows the tensor's device.
    ``k``        -- panel width of the rank-K update.
    ``shrink``/``min_size`` -- staged-schedule geometry.
    ``lookahead`` -- mesh-only (not ported yet).
    ``fused``    -- one-pass condensation steps and one composed-
                   permutation gather per panel (bit-identical results).
    ``precision`` -- ``None`` or ``"bf16"``: bf16 GEMM / outer-product
                   operands, full-precision buffer and accumulators.
    ``nb``       -- block-cyclic tile of the ScaLAPACK-style baseline;
                   kept so configs round-trip with the JAX package.
    """
    k: int = 32
    nb: int = 1
    schedule: Optional[str] = None
    update: Optional[str] = None
    backend: str = "auto"
    shrink: float = 0.75
    min_size: int = 64
    lookahead: bool = False
    fused: bool = False
    precision: Optional[str] = None

    def __post_init__(self):
        _require(int(self.k) >= 1, f"k must be >= 1, got {self.k}")
        _require(int(self.nb) >= 1, f"nb must be >= 1, got {self.nb}")
        _require(self.schedule is None or self.schedule in _ENGINE_SCHEDULES,
                 f"unknown schedule {self.schedule!r}; "
                 f"one of {_ENGINE_SCHEDULES}")
        _require(self.update is None or self.update in _ENGINE_UPDATES,
                 f"unknown update {self.update!r}; one of {_ENGINE_UPDATES}")
        _require(self.backend == "auto",
                 f"unknown backend {self.backend!r}; repro_torch has only "
                 "'auto' (the kernel follows the tensor's device)")
        _require(0.0 < float(self.shrink) < 1.0,
                 f"shrink must be in (0, 1), got {self.shrink}")
        _require(int(self.min_size) >= 2,
                 f"min_size must be >= 2, got {self.min_size}")
        _require(not self.lookahead or self.schedule in (None, "mesh"),
                 "lookahead pipelines the mesh schedule's broadcast; it "
                 f"requires schedule='mesh' (or unset), got "
                 f"{self.schedule!r}")
        _require(not self.fused or self.schedule != "mesh",
                 "fused one-pass steps are a serial/staged optimization; "
                 "the mesh schedule pipelines via lookahead instead")
        _require(self.precision in (None, "bf16"),
                 f"unknown precision {self.precision!r}; "
                 "one of (None, 'bf16')")

    def resolved(self) -> "ExactConfig":
        """Pin the engine axes (plan-time resolution of the defaults)."""
        if self.schedule == "mesh" or self.lookahead:
            raise NotImplementedError(
                "the mesh schedule and lookahead are not ported to "
                "repro_torch yet (ROADMAP Queue 1 item 8)")
        sched = self.schedule or "staged"
        upd = self.update or "rank1"
        if sched == self.schedule and upd == self.update:
            return self
        return dataclasses.replace(self, schedule=sched, update=upd)

    def engine_config(self) -> EngineConfig:
        """The `EngineConfig` this config denotes (axes must be resolved)."""
        _require(self.schedule is not None and self.update is not None,
                 "engine axes unresolved; call .resolved() first")
        return EngineConfig(schedule=self.schedule, update=self.update,
                            panel_k=self.k, backend=self.backend,
                            shrink=self.shrink, min_size=self.min_size,
                            lookahead=self.lookahead, fused=self.fused,
                            precision=self.precision)


def config_for(method: str, kwargs: dict) -> ExactConfig:
    """Build the typed config for ``method`` from keywords; unknown
    keywords raise by name."""
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    names = {f.name for f in dataclasses.fields(ExactConfig)}
    extra = set(kwargs) - names
    if extra:
        raise TypeError(
            f"unknown keywords for method 'exact': {sorted(extra)} "
            f"(valid: {sorted(names)})")
    return ExactConfig(**kwargs)


def config_to_dict(config: ExactConfig) -> dict:
    """JSON-safe dict encoding of a config, tagged with its class (the
    same encoding as `repro.core.configs.config_to_dict`)."""
    if not isinstance(config, ExactConfig):
        raise TypeError(f"not an exact config: {type(config).__name__}")
    return {"type": type(config).__name__, **dataclasses.asdict(config)}


def config_from_dict(d: dict) -> ExactConfig:
    """Rebuild a config from `config_to_dict` output (validating)."""
    d = dict(d)
    name = d.pop("type", None)
    if name != "ExactConfig":
        raise ValueError(f"unknown config type {name!r}; repro_torch has "
                         "ExactConfig only (estimators: ROADMAP Queue 1 "
                         "item 7)")
    names = {f.name for f in dataclasses.fields(ExactConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown fields for {name}: {sorted(extra)}")
    return ExactConfig(**d)


def from_jax_config(d: dict) -> ExactConfig:
    """The port's config for the route a JAX plan's config names.

    ``d`` is `repro.core.configs.config_to_dict` of a (resolved)
    `repro.core.configs.ExactConfig`.  Its kernel backend maps to
    ``"auto"``, because in the port the kernel follows the tensor's
    device; the mesh schedule and lookahead are rejected (not ported).
    """
    d = dict(d)
    backend = d.get("backend", "auto")
    if backend not in _JAX_BACKENDS:
        raise ValueError(f"unknown JAX kernel backend {backend!r}")
    if d.get("schedule") == "mesh" or d.get("lookahead"):
        raise NotImplementedError(
            "the mesh schedule and lookahead are not ported to repro_torch "
            "yet (ROADMAP Queue 1 item 8)")
    d["backend"] = "auto"
    return config_from_dict(d)
