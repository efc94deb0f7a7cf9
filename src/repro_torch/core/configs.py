"""Typed configuration for `repro_torch.plan`.

Counterpart of `repro.core.configs`: `ExactConfig`, `ChebyshevConfig` and
`SLQConfig` keep the JAX package's fields and validation, so one dict
describes a route in both packages.  `from_jax_config` carries a JAX
plan's config across (the matrix, a band table or a probe slab cross as
numpy arrays).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.core.engine import (
    EngineConfig, LEGACY_ROUTES, SCHEDULES as _ENGINE_SCHEDULES,
    UPDATES as _ENGINE_UPDATES,
)

__all__ = ["ExactConfig", "ChebyshevConfig", "SLQConfig", "LogdetConfig",
           "EngineConfig", "config_for", "filter_for_method",
           "config_to_dict", "config_from_dict", "from_jax_config",
           "BASELINE_METHODS", "EXACT_METHODS", "ESTIMATOR_METHODS",
           "PARALLEL_METHODS", "METHODS", "LEGACY_EXACT_ROUTES"]

# the Gaussian-elimination baselines: serial GE, parallel GE, blocked LU
BASELINE_METHODS = ("ge", "pge", "plu")
# the JAX package's method tuples: "exact" is the condensation engine, the
# five legacy route strings deprecated aliases for fixed engine tuples
# (`engine.LEGACY_ROUTES`), ge/pge/plu the baselines
LEGACY_EXACT_ROUTES = tuple(LEGACY_ROUTES)
EXACT_METHODS = ("exact",) + LEGACY_EXACT_ROUTES + BASELINE_METHODS
PARALLEL_METHODS = ("pmc", "pmc_blocked", "pge", "plu")
ESTIMATOR_METHODS = ("chebyshev", "slq")
METHODS = EXACT_METHODS + ESTIMATOR_METHODS

# the JAX package's kernel backends; the port accepts them only in a dict
# carried across by `from_jax_config`, where each maps to "auto"
_JAX_BACKENDS = ("auto", "xla", "pallas", "interpret")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class ExactConfig:
    """Knobs of the exact condensation engine (``method="exact"``).

    ``schedule`` -- "serial" | "staged" | "mesh"; ``None`` resolves at plan
                   time ("mesh" when a mesh is supplied, else "staged").
    ``update``   -- "rank1" | "panel"; ``None`` resolves to "rank1".
    ``backend``  -- "auto" only: the kernel follows the tensor's device.
    ``k``        -- panel width of the rank-K update.
    ``shrink``/``min_size`` -- staged-schedule geometry.
    ``lookahead`` -- mesh-only: pipeline the next pivot row / panel so its
                   broadcast overlaps the current bulk update
                   (bit-identical results).  Requires ``schedule`` unset
                   (mesh resolves when a mesh is present) or ``"mesh"``.
    ``fused``    -- one-pass condensation steps and one composed-
                   permutation gather per panel (bit-identical results).
    ``precision`` -- ``None`` or ``"bf16"``: bf16 GEMM / outer-product
                   operands, full-precision buffer and accumulators.
    ``nb``       -- block size of the ScaLAPACK-style baseline
                   (``method="plu"``).
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

    def resolved(self, *, mesh_present: bool = False) -> "ExactConfig":
        """Pin the engine axes (plan-time resolution of the defaults)."""
        sched = self.schedule or ("mesh" if mesh_present else "staged")
        if self.lookahead and sched != "mesh":
            raise ValueError(
                "lookahead requires the mesh schedule: pass a mesh (or "
                f"schedule='mesh'); resolution chose {sched!r}")
        if self.fused and sched == "mesh":
            raise ValueError(
                "fused one-pass steps are a serial/staged optimization "
                "(the mesh schedule pipelines via lookahead); drop the "
                "mesh or pass schedule='serial'/'staged' explicitly")
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


@dataclass(frozen=True)
class ChebyshevConfig:
    """Knobs of the stochastic Chebyshev estimator (SPD input).

    ``degree``       expansion degree -- truncation bias decays ~rho^-degree
    ``num_probes``   Hutchinson probes -- noise shrinks ~1/sqrt(num_probes)
    ``probe_kind``   "rademacher" (variance-minimizing) or "gaussian"
    ``seed``         seed of the plan's generator when none is passed at
                     call time
    ``lmin``/``lmax`` spectral bounds; None -> power-iteration bracket
    ``grad_cg_tol``/``grad_cg_maxiter`` backward-pass CG solve control
    """
    degree: int = 64
    num_probes: int = 32
    probe_kind: str = "rademacher"
    seed: int = 0
    lmin: Optional[float] = None
    lmax: Optional[float] = None
    grad_cg_tol: float = 1e-8
    grad_cg_maxiter: Optional[int] = None

    def __post_init__(self):
        _require(int(self.degree) >= 1,
                 f"degree must be >= 1, got {self.degree}")
        _require(int(self.num_probes) >= 1,
                 f"num_probes must be >= 1, got {self.num_probes}")
        _require(self.probe_kind in ("rademacher", "gaussian"),
                 f"unknown probe_kind {self.probe_kind!r}")
        for name in ("lmin", "lmax"):
            v = getattr(self, name)
            if v is None:
                continue
            try:
                # a hashable float: configs key the plan cache
                object.__setattr__(self, name, float(v))
            except (TypeError, ValueError, RuntimeError):
                raise TypeError(
                    f"{name} in the config must be a scalar; pass tensor "
                    f"bounds at execution time instead (plan(a)({name}="
                    f"...))") from None
        if self.lmin is not None and self.lmax is not None:
            _require(float(self.lmax) > float(self.lmin),
                     f"need lmax > lmin, got [{self.lmin}, {self.lmax}]")

    def estimator_kwargs(self) -> dict:
        """Keywords for `repro_torch.estimators.estimate_logdet`."""
        kw = dict(degree=self.degree, num_probes=self.num_probes,
                  probe_kind=self.probe_kind, seed=self.seed,
                  grad_cg_tol=self.grad_cg_tol,
                  grad_cg_maxiter=self.grad_cg_maxiter)
        if self.lmin is not None:
            kw["lmin"] = self.lmin
        if self.lmax is not None:
            kw["lmax"] = self.lmax
        return kw


@dataclass(frozen=True)
class SLQConfig:
    """Knobs of the stochastic Lanczos quadrature estimator (SPD input).

    ``num_steps``    Lanczos steps -- quadrature error ~exp(-4m/sqrt(cond))
    ``num_probes``   Hutchinson probes -- noise shrinks ~1/sqrt(num_probes)
    ``seed``         seed of the plan's generator when none is passed at
                     call time
    ``grad_cg_tol``/``grad_cg_maxiter`` backward-pass CG solve control
    """
    num_steps: int = 25
    num_probes: int = 32
    seed: int = 0
    grad_cg_tol: float = 1e-8
    grad_cg_maxiter: Optional[int] = None

    def __post_init__(self):
        _require(int(self.num_steps) >= 1,
                 f"num_steps must be >= 1, got {self.num_steps}")
        _require(int(self.num_probes) >= 1,
                 f"num_probes must be >= 1, got {self.num_probes}")

    def estimator_kwargs(self) -> dict:
        """Keywords for `repro_torch.estimators.estimate_logdet`."""
        return dict(num_steps=self.num_steps, num_probes=self.num_probes,
                    seed=self.seed, grad_cg_tol=self.grad_cg_tol,
                    grad_cg_maxiter=self.grad_cg_maxiter)


LogdetConfig = Union[ExactConfig, ChebyshevConfig, SLQConfig]
_CONFIG_CLS = {"exact": ExactConfig, "chebyshev": ChebyshevConfig,
               "slq": SLQConfig,
               **{m: ExactConfig for m in BASELINE_METHODS}}
_BY_NAME = {cls.__name__: cls for cls in _CONFIG_CLS.values()}
_ESTIMATOR_KW = ({f.name for f in dataclasses.fields(ChebyshevConfig)}
                 | {f.name for f in dataclasses.fields(SLQConfig)})


def config_for(method: str, kwargs: dict) -> LogdetConfig:
    """Build the typed config for ``method`` from keywords; unknown
    keywords raise by name (estimator keywords on ``exact`` as a
    TypeError saying so)."""
    cls = _CONFIG_CLS.get(method)
    if cls is None:
        raise ValueError(f"unknown method {method!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(kwargs) - names
    if extra:
        if cls is ExactConfig and extra & _ESTIMATOR_KW:
            raise TypeError(f"method {method!r} takes no estimator "
                            f"keywords: {sorted(extra)}")
        raise TypeError(
            f"unknown keywords for method {method!r}: {sorted(extra)} "
            f"(valid: {sorted(names)})")
    return cls(**kwargs)


def filter_for_method(method: str, kwargs: dict) -> dict:
    """Keep the keywords the resolved method's family understands.

    Used by ``method="auto"``: knobs of the family the selector did not
    pick are dropped (exact is at least as accurate), while names no
    family defines still raise, as in `repro.core.configs
    .filter_for_method`.
    """
    known = set().union(*({f.name for f in dataclasses.fields(c)}
                          for c in (ExactConfig, ChebyshevConfig,
                                    SLQConfig)))
    unknown = set(kwargs) - known
    if unknown:
        raise TypeError(
            f"unknown keywords: {sorted(unknown)} (no method understands "
            f"them; valid names: {sorted(known)})")
    cls = _CONFIG_CLS.get(method)
    if cls is None:
        raise ValueError(f"unknown method {method!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kwargs.items() if k in names}


def config_to_dict(config: LogdetConfig) -> dict:
    """JSON-safe dict encoding of a config, tagged with its class (the
    same encoding as `repro.core.configs.config_to_dict`)."""
    if not isinstance(config, tuple(_CONFIG_CLS.values())):
        raise TypeError(f"not a logdet config: {type(config).__name__}")
    return {"type": type(config).__name__, **dataclasses.asdict(config)}


def config_from_dict(d: dict) -> LogdetConfig:
    """Rebuild a config from `config_to_dict` output (validating)."""
    d = dict(d)
    name = d.pop("type", None)
    cls = _BY_NAME.get(name)
    if cls is None:
        raise ValueError(f"unknown config type {name!r}; one of "
                         f"{sorted(_BY_NAME)}")
    names = {f.name for f in dataclasses.fields(cls)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown fields for {name}: {sorted(extra)}")
    return cls(**d)


def from_jax_config(d: dict) -> LogdetConfig:
    """The port's config for the route a JAX plan's config names.

    ``d`` is `repro.core.configs.config_to_dict` of a JAX config.  An
    `ExactConfig`'s kernel backend maps to ``"auto"``, because in the port
    the kernel follows the tensor's device; every other field, the mesh
    schedule and lookahead included, crosses as it is, as do the
    estimator configs.
    """
    d = dict(d)
    if d.get("type") != "ExactConfig":
        return config_from_dict(d)
    backend = d.get("backend", "auto")
    if backend not in _JAX_BACKENDS:
        raise ValueError(f"unknown JAX kernel backend {backend!r}")
    d["backend"] = "auto"
    return config_from_dict(d)
