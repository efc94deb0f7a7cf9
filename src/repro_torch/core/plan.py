"""``repro_torch.plan()`` -- the plan/execute log-determinant API.

Counterpart of `repro.core.plan`: the decision of what to run is made
once, at plan time, and the plan is then called on data::

    p = repro_torch.plan(a, method="exact", update="panel")
    sign, logabsdet = p(a)          # LogdetResult, tensors on the card
    res = repro_torch.plan(op, method="slq", num_steps=25)(generator=g)
    res.logabsdet, res.sem          # estimate and its standard error

``method`` is ``"auto"`` (the default: the cost model below picks),
``"exact"`` (the condensation engine), one of the paper's baselines --
``"ge"`` (serial Gaussian elimination), ``"pge"`` (parallel GE) and
``"plu"`` (blocked LU, ``nb=``), the last two on a mesh -- or an
estimator, ``"chebyshev"`` or ``"slq"``, on a dense SPD matrix or on an
operator (`repro_torch.estimators.StencilOperator`, or any object with
``shape``, ``dtype`` and ``mm``).  Plans run on the card unless the caller asks for
the CPU: ``device=None`` resolves to ``"cuda"`` and raises when there is
none; ``device="cpu"`` runs the plain PyTorch versions of the kernels.
An input on another device is moved to the plan's device, an operator
through its ``to`` when the plan is built (one without ``to`` raises);
the caller's tensor or operator is never modified.

With ``mesh=`` (a `repro_torch.core.mesh.Mesh`, one process per rank)
the exact method runs the paper's parallel schedule (``schedule``
resolves to ``"mesh"``) and the estimators a row-sharded operator
(`estimators.ShardedOperator`); the matrix is padded to a multiple of
the mesh size with diag(A, I).  Every rank builds and calls the same
plan on the same full matrix and gets the same result, on
``mesh.device``.

The cost model (`select_route` / `select_method`) is the JAX package's
(`repro.core.plan`): an operator goes to an estimator, ``rtol`` below
1e-3 to the exact family, and otherwise the modeled seconds of the best
exact engine route (`core.calibration.exact_cost`, panel width from
`kernels.autotune`) against the estimator's probe budget
(`estimator_cost`) decide, exact winning below 0.05 s; the estimator is
``chebyshev`` when ``lmin`` and ``lmax`` are given, else ``slq``.  The
port's table (``bench_out/torch_roofline_calibration.json``, measured on
the card by ``tools/torch_calibrate.py``) adds the host's dispatch time
per eliminated row to every exact route.

Gradients follow one autograd rule per path (`estimators.grad`), never
the elimination or the estimator recurrence: ``plan(...).logdet(x)`` of an
``x`` that requires a gradient backpropagates ``g * inv(x).T`` on every
exact method, and on an estimator the Hutchinson pullback on the forward's
own probes (one transposed CG solve) onto the matrix or the operator's
parameters (a stencil's bands).  ``value_and_grad(a, generator=...)``
returns the value and that gradient together, the estimators' backward CG
iterations in ``diagnostics.cg_iters``; ``plan(..., grad=True)`` builds
that callable with the plan.  On a mesh every rank gets the full
gradient: the exact methods invert the matrix on each rank's device, the
sharded estimators solve through ``ShardedOperator.rmm``.

A (B, n, n) stack (a tensor or array, or a
`repro_torch.estimators.BatchedOperator`) gives (B,) results: the exact
methods ``exact`` (any serial or staged route) and ``ge`` run every step
on the whole stack at once, each kernel launching once for it (K1-K4's
batch grids), each matrix padded on its own; the estimators run a
`BatchedOperator` (batched matmuls, per-matrix bounds and probes
(B, n, k)).  ``value_and_grad`` returns the (B, n, n) gradient of each
matrix's log|det|.  A mesh, ``pge`` and ``plu`` take one matrix and raise
`TypeError` on a stack, as in the JAX package.

Observability (`repro_torch.obs`, ``REPRO_OBS=off|metrics|trace``) uses
the JAX package's names: the spans ``plan.build``, ``plan.execute`` and
``plan.backward``, the counters ``plan.cache.hits`` / ``misses``,
``plan.executions`` and ``estimator.probes``, the gauge
``plan.flops_est``, the histogram ``cg.iters``, and in ``trace`` mode the
estimators' convergence telemetry in ``diagnostics.convergence``.  The
JAX package's ``plan.traces`` / ``plan.retraces`` and ``plan.compile``
count jit traces, which eager PyTorch has not.  ``explain`` prints what a
plan resolved to and what it has observed.

``export`` writes the plan's resolved form for ``repro_torch.load_plan``
(`repro_torch.serve.aot`: the spec, the explicit config and a fingerprint
naming the card and the kernel build; no executable, as the port has
none to serialize).

``audit`` records one call of the plan and runs the checker passes of
`repro_torch.analysis` over it.  The JAX package's legacy route strings
``mc``, ``mc_staged``, ``mc_blocked``, ``pmc`` and ``pmc_blocked`` resolve,
with a `DeprecationWarning`, to ``method="exact"`` with the schedule and
update each pins (`engine.LEGACY_ROUTES`).
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.api import pad_to_multiple
from repro_torch.core.calibration import (Calibration, estimator_cost,
                                          exact_cost, load_calibration)
from repro_torch.core.configs import (
    BASELINE_METHODS, LEGACY_EXACT_ROUTES, ChebyshevConfig, ExactConfig,
    LogdetConfig, config_for, filter_for_method,
)
from repro_torch.core.engine import (EngineConfig, LEGACY_ROUTES, build_mesh,
                                     build_serial)
from repro_torch.core.gaussian import parallel_slogdet_ge, slogdet_ge
from repro_torch.core.mesh import Mesh
from repro_torch.core.result import Diagnostics, LogdetResult
from repro_torch.core.scalapack import parallel_slogdet_lu
from repro_torch.estimators import (
    ESTIMATOR_METHODS, ShardedOperator, estimate_logdet, exact_slogdet_vjp,
    hutchinson_pullback, is_operator, operator_grad_info, operator_on,
    shared_probes,
)
from repro_torch.estimators.chebyshev import default_generator
from repro_torch.estimators.operators.base import device_of, resolve_device

__all__ = ["plan", "LogdetPlan", "ProblemSpec", "spec_of", "select_method",
           "select_route", "clear_plan_cache"]

_DTYPES = (torch.float32, torch.float64)
_EXACT_METHODS = ("exact", *BASELINE_METHODS)
_METHODS = (*_EXACT_METHODS, *ESTIMATOR_METHODS)
# single-column matvecs of the power-iteration bounds (two runs of 32
# iterations plus their Rayleigh quotients), as in the JAX package
_BOUNDS_COLS = 2 * (32 + 1)


# --------------------------------------------------------------------------
# problem specification
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ProblemSpec:
    """What a plan is built for: ``kind`` "dense" | "batched" |
    "operator", the matrix side ``n``, the stack size ``batch`` (or
    None), the dtype name, the operator's ``structure`` tag ("dense" for
    arrays), the FLOPs ``matvec_flops`` of one matvec column, whether
    exact methods could run on the input (``materializable``) and the
    devices the operator's own product spans (``device_count``) -- the
    cost model's inputs."""
    kind: str
    n: int
    batch: Optional[int]
    dtype: str
    structure: str = "dense"
    matvec_flops: float = 0.0
    materializable: bool = True
    device_count: int = 1


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and isinstance(getattr(torch, d, None),
                                         torch.dtype):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(d))).dtype


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def spec_of(x, dtype=None) -> ProblemSpec:
    """Coerce an int N, a shape tuple, an array, a tensor or an operator
    (or an existing spec) into a `ProblemSpec`."""
    if isinstance(x, ProblemSpec):
        return x
    if is_operator(x):
        hints = x.plan_hints() if hasattr(x, "plan_hints") else None
        n = int(x.shape[-1])
        return ProblemSpec(
            kind="operator", n=n, batch=getattr(x, "batch", None),
            dtype=_dtype_name(_torch_dtype(x.dtype)),
            structure=hints.structure if hints else "implicit",
            matvec_flops=float(hints.matvec_flops) if hints
            else 2.0 * n * n,
            materializable=bool(hints.materializable) if hints else False,
            device_count=int(hints.device_count) if hints else 1)
    if isinstance(x, int):
        shape = (x, x)
    elif isinstance(x, tuple):
        shape = x
    elif hasattr(x, "shape"):
        shape = tuple(x.shape)
        dtype = dtype if dtype is not None else x.dtype
    else:
        raise TypeError(f"cannot plan for {type(x).__name__}; pass a size, "
                        "a shape tuple, an array or a tensor")
    dt = _torch_dtype(dtype) if dtype is not None \
        else torch.get_default_dtype()
    if len(shape) == 2 and shape[0] == shape[1]:
        n, batch, kind = int(shape[0]), None, "dense"
    elif len(shape) == 3 and shape[1] == shape[2]:
        n, batch, kind = int(shape[1]), int(shape[0]), "batched"
    else:
        raise ValueError(
            f"expected square matrix (n, n) or stack (B, n, n), got {shape}")
    return ProblemSpec(kind=kind, n=n, batch=batch, dtype=_dtype_name(dt),
                       structure=kind, matvec_flops=2.0 * n * n)


# --------------------------------------------------------------------------
# cost model
# --------------------------------------------------------------------------

# probe budget the selector assumes when none is configured: the SLQ
# defaults (bounds-free, the conservative estimator choice)
_DEFAULT_EST_COLS = 25 * 32
# Monte-Carlo noise floor: below this requested rtol the selector goes
# exact
_EST_RTOL_FLOOR = 1e-3
# panel updates are offered only from this many panels' worth of rows
_PANEL_MIN_N_FACTOR = 4
# below this modeled exact wall time the estimators have nothing to offer
_EXACT_FREE_SECONDS = 0.05


def select_route(x, *, mesh=None, rtol: Optional[float] = None,
                 bounds_known: bool = False,
                 est_cols: Optional[int] = None,
                 calibration: Optional[Calibration] = None,
                 precision: Optional[str] = None,
                 ) -> Tuple[str, Optional[EngineConfig]]:
    """Resolve ``method="auto"`` to ``(method, engine_config)``, as
    `repro.core.plan.select_route` does.

    The estimators carry ``None``; the exact family returns the cheapest
    `EngineConfig` (schedule x update, ``panel_k`` from the tile
    autotuner, lookahead on a mesh) under the calibration table
    (`core.calibration.load_calibration` unless ``calibration`` is given).
    ``mesh`` (a `core.mesh.Mesh`) sets the device count; without one the
    spec's ``device_count`` does.  ``precision="bf16"`` prices GEMM work at
    the bf16 rate and keeps to the exact family.  Pure and cheap.
    """
    spec = spec_of(x)
    devices = mesh.size if mesh is not None else spec.device_count
    est_method = "chebyshev" if bounds_known else "slq"

    if spec.kind == "operator":
        # only the matrix-free estimators run on operator inputs
        return est_method, None

    cal = calibration if calibration is not None else load_calibration()
    itemsize = _torch_dtype(spec.dtype).itemsize
    route, exact_t = _best_exact_route(spec, devices, cal, itemsize,
                                       precision=precision)

    if precision == "bf16":
        # the quantized-GEMM route only exists in the exact engine
        return "exact", route
    if rtol is not None and rtol < _EST_RTOL_FLOOR:
        return "exact", route

    cols = est_cols if est_cols is not None \
        else _DEFAULT_EST_COLS + _BOUNDS_COLS
    est_t = estimator_cost(spec.n, cols, spec.matvec_flops, devices, cal,
                           itemsize=itemsize, batch=spec.batch or 1)
    # leave the exact family only when exact is both slow enough to care
    # about and modeled slower than the estimator budget
    if exact_t <= _EXACT_FREE_SECONDS or exact_t <= est_t:
        return "exact", route
    return est_method, None


def select_method(x, *, mesh=None, rtol: Optional[float] = None,
                  bounds_known: bool = False,
                  est_cols: Optional[int] = None,
                  calibration: Optional[Calibration] = None) -> str:
    """The method name `select_route` resolves to."""
    return select_route(x, mesh=mesh, rtol=rtol, bounds_known=bounds_known,
                        est_cols=est_cols, calibration=calibration)[0]


def _best_exact_route(spec: ProblemSpec, devices: int, cal: Calibration,
                      itemsize: int, precision: Optional[str] = None,
                      ) -> Tuple[EngineConfig, float]:
    """Cheapest exact engine instantiation under the calibration table,
    and its modeled seconds."""
    from repro_torch.kernels.autotune import resolved_panel_k
    n, b = spec.n, spec.batch or 1
    tuned_k = resolved_panel_k(n, itemsize=itemsize, precision=precision,
                               cal=cal)
    if spec.batch is not None:
        # stacks run one matrix per device (serial schedule)
        candidates = [("serial", "rank1", 1, False),
                      ("serial", "panel", 1, False)]
    else:
        candidates = [("staged", "rank1", 1, False),
                      ("staged", "panel", 1, False)]
        if devices > 1:
            # each mesh route plain and pipelined
            candidates += [("mesh", "rank1", devices, False),
                           ("mesh", "panel", devices, False),
                           ("mesh", "rank1", devices, True),
                           ("mesh", "panel", devices, True)]
    if n < _PANEL_MIN_N_FACTOR * tuned_k:
        candidates = [c for c in candidates if c[1] != "panel"]

    def cost_of(c):
        schedule, update, devs, la = c
        return exact_cost(n, devs, cal, update=update, panel_k=tuned_k,
                          itemsize=itemsize, batch=b, lookahead=la,
                          precision=precision)

    best = min(candidates, key=cost_of)
    schedule, update, devs, la = best
    return EngineConfig(schedule=schedule, update=update, panel_k=tuned_k,
                        lookahead=la, precision=precision), cost_of(best)


# --------------------------------------------------------------------------
# the forward callable
# --------------------------------------------------------------------------

def _serial_exact_core(method: str, cfg: ExactConfig) -> Callable:
    """``a -> (sign, logabsdet)`` of one matrix, or of each matrix of a
    stack at once."""
    if method == "ge":
        return slogdet_ge
    ecfg = cfg.engine_config()
    fn = build_serial(ecfg)
    if ecfg.update == "panel":
        # pad so every panel is full; diag(A, I) preserves the result (of
        # each matrix of a stack)
        k = ecfg.panel_k
        return lambda x: fn(pad_to_multiple(x, k))
    return fn


def _widen_bounds_for_padding(kw: dict) -> dict:
    """diag(A, I) padding adds unit eigenvalues: Chebyshev bounds must be
    widened to bracket 1, else T_j blows up outside [-1, 1] on the padded
    directions."""
    kw = dict(kw)
    for name, bound in (("lmin", {"max": 1.0}), ("lmax", {"min": 1.0})):
        if kw.get(name) is not None:
            kw[name] = torch.as_tensor(kw[name],
                                       dtype=torch.float64).clamp(**bound)
    return kw


def _build_forward(spec: ProblemSpec, method: str, cfg: LogdetConfig,
                   device: torch.device,
                   mesh: Optional[Mesh]) -> Tuple[Callable, int]:
    """(fwd, padded_n): fwd maps an input (and, for an estimator, the
    call-time ``generator``/``probes``/``lmin``/``lmax``) to ``(sign,
    logabsdet, sem)`` on ``device``."""
    dtype = getattr(torch, spec.dtype)
    if _is_mesh_exact(method, cfg):
        size = mesh.size
        # diag(A, I) padding: to a multiple of P, for plu of lcm(P, nb)
        mult = math.lcm(size, cfg.nb) if method == "plu" else size
        if method == "exact":
            core = build_mesh(cfg.engine_config(), mesh)
        elif method == "pge":
            core = parallel_slogdet_ge(mesh)
        else:
            core = parallel_slogdet_lu(mesh, nb=cfg.nb)
        # the VJP wraps the padding too: the gradient is n x n
        wrapped = exact_slogdet_vjp(lambda x: core(pad_to_multiple(x, mult)))

        def fwd(a):
            a = torch.as_tensor(a).to(device=device, dtype=dtype)
            sign, ld = wrapped(a)
            return sign, ld, torch.zeros_like(ld)

        return fwd, -(-spec.n // mult) * mult

    if method in _EXACT_METHODS:
        padded_n = spec.n
        if method == "exact" and cfg.update == "panel" and spec.n:
            padded_n = -(-spec.n // cfg.k) * cfg.k
        wrapped = exact_slogdet_vjp(_serial_exact_core(method, cfg))

        def fwd(a):
            sign, ld = wrapped(torch.as_tensor(a).to(device=device,
                                                     dtype=dtype))
            return sign, ld, torch.zeros_like(ld)

        return fwd, padded_n

    est_kw = cfg.estimator_kwargs()
    size = mesh.size if mesh is not None else 1
    padded_n = -(-spec.n // size) * size

    def fwd(x, generator=None, probes=None, lmin=None, lmax=None):
        op = _estimator_operator(x, spec, device, mesh)
        kw = dict(est_kw)
        if lmin is not None:
            kw["lmin"] = lmin
        if lmax is not None:
            kw["lmax"] = lmax
        if padded_n != spec.n:
            kw = _widen_bounds_for_padding(kw)
        if probes is not None:
            probes = torch.as_tensor(probes).to(device=device, dtype=dtype)
        res = estimate_logdet(op, method=method, device=device,
                              generator=generator, probes=probes, **kw)
        return torch.ones_like(res.est), res.est, res.sem

    return fwd, padded_n


def _estimator_operator(x, spec: ProblemSpec, device: torch.device,
                        mesh: Optional[Mesh]):
    """The operator an estimator plan runs on: an operator input on
    ``device``; a dense input as a `DenseOperator` there, or on a mesh a
    `ShardedOperator` of diag(A, I) padded to a multiple of its size."""
    if spec.kind == "operator":
        return operator_on(x, device)
    a = torch.as_tensor(x).to(device=device, dtype=getattr(torch, spec.dtype))
    if mesh is not None:
        return ShardedOperator(pad_to_multiple(a, mesh.size), mesh)
    return operator_on(a, device)


def _build_value_and_grad(spec: ProblemSpec, method: str, cfg: LogdetConfig,
                          device: torch.device, mesh: Optional[Mesh],
                          fwd: Callable) -> Callable:
    """vag(x, generator) -> ((sign, logabsdet, sem), grad, cg_iters).

    The gradient of ``logabsdet`` with respect to the input: the dense
    matrix, or an operator's own parameters.  Exact methods run the plan's
    own forward ``fwd``, then ``inv(a).T`` (no collective on a mesh: every
    rank inverts the full matrix).  Estimators draw the probes as the
    forward does, so the value equals ``__call__``'s with the same
    generator, and run `hutchinson_pullback` explicitly so that its CG
    iteration count (else None) can be reported.
    """
    dtype = getattr(torch, spec.dtype)
    if method in _EXACT_METHODS:
        def vag(x, generator=None):
            a = torch.as_tensor(x).to(device=device, dtype=dtype)
            sign, ld, sem = fwd(a)
            if a.shape[-1] == 0:
                return (sign, ld, sem), torch.zeros_like(a), None
            # one (batched) inverse: each matrix's A^{-T}, inf/NaN where
            # A is singular (no raise, no host check of the info)
            return (sign, ld, sem), torch.linalg.inv_ex(a).inverse.mT, None

        return vag

    est_kw = cfg.estimator_kwargs()
    # the forward widens Chebyshev bounds only where the mesh padded
    padded = mesh is not None and spec.n % mesh.size != 0

    def vag(x, generator=None):
        op = _estimator_operator(x, spec, device, mesh)
        info = operator_grad_info(op)
        if info is None:
            raise TypeError(
                f"value_and_grad needs an operator with a gradient "
                f"registration; {type(op).__name__} has none (see "
                "repro_torch.estimators.register_operator_grad)")
        if generator is None:
            generator = default_generator(device_of(op), cfg.seed)
        probes = shared_probes(method, op, generator, est_kw)
        kw = _widen_bounds_for_padding(est_kw) if padded else est_kw
        res = estimate_logdet(op, method=method, device=device,
                              generator=generator, probes=probes, **kw)
        bar, cg = hutchinson_pullback(
            op, info.params(op), probes, torch.ones_like(res.est),
            info=info, cg_tol=cfg.grad_cg_tol, cg_maxiter=cfg.grad_cg_maxiter)
        if mesh is not None:
            # d logdet(diag(A, I)) / dA is the A-block of the padded
            # pullback
            bar = bar[:spec.n, :spec.n]
        return (torch.ones_like(res.est), res.est, res.sem), bar, cg.iters

    return vag


def _is_mesh_exact(method: str, cfg: LogdetConfig) -> bool:
    """Does this exact method distribute one matrix over a mesh?"""
    return method in ("pge", "plu") or (method == "exact"
                                        and cfg.schedule == "mesh")


def _flops_est(method: str, spec: ProblemSpec, cfg: LogdetConfig,
               devices: int) -> Tuple[Optional[int], float]:
    """(matvec_cols, flops_est) diagnostics for the resolved path, per
    device (all matrices of a stack)."""
    b = spec.batch or 1
    if method in _EXACT_METHODS:
        return None, b * (2.0 / 3.0) * spec.n ** 3 / devices
    if isinstance(cfg, ChebyshevConfig):
        cols = cfg.degree * cfg.num_probes
        if cfg.lmin is None or cfg.lmax is None:
            cols += _BOUNDS_COLS
    else:
        cols = min(cfg.num_steps, spec.n) * cfg.num_probes
    return cols, b * cols * spec.matvec_flops / devices


# --------------------------------------------------------------------------
# the plan artifact
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LogdetPlan:
    """A log-determinant computation: spec + typed config + device +
    the forward callable.  Build with `repro_torch.plan`; call with data."""
    spec: ProblemSpec
    method: str
    config: LogdetConfig
    device: torch.device
    grad: bool = False
    validate: bool = True
    diagnostics: Diagnostics = field(default_factory=Diagnostics)
    _fwd: Callable = field(default=None, repr=False, compare=False)
    _mesh: Optional[Mesh] = field(default=None, repr=False, compare=False)
    # the value_and_grad callable, built on first use or by grad=True
    _cache: dict = field(default_factory=dict, repr=False, compare=False)
    _bound: Any = field(default=None, repr=False, compare=False)

    def __call__(self, a=None, *, generator=None, probes=None, lmin=None,
                 lmax=None) -> LogdetResult:
        """Execute the plan -> `LogdetResult` (``wall_time_s`` is taken
        after the card has finished).

        ``generator``/``probes``/``lmin``/``lmax`` are estimator inputs of
        this call: a `torch.Generator` in place of the config's ``seed``,
        a pre-drawn (n, k) probe slab, spectral bounds (numbers or
        tensors) in place of the power-iteration bracket.
        """
        x = self._input(a)
        x = self._check(x, generator, probes, lmin, lmax)
        tele = _telemetry_start()
        t0 = time.perf_counter()
        with obs.span("plan.execute", method=self.method):
            sign, ld, sem = self._run(x, generator, probes, lmin, lmax)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
            conv = self._telemetry_end(tele)
            obs.inc("plan.executions", method=self.method)
            if self.method in ESTIMATOR_METHODS:
                obs.inc("estimator.probes", self.config.num_probes)
        diags = dataclasses.replace(self.diagnostics, wall_time_s=wall,
                                    convergence=conv)
        return LogdetResult(sign=sign, logabsdet=ld, sem=sem,
                            method_used=self.method, diagnostics=diags)

    def slogdet(self, a=None, *, generator=None, probes=None, lmin=None,
                lmax=None):
        """Raw ``(sign, logabsdet)`` pair: no validation, no diagnostics,
        no sync."""
        sign, ld, _ = self._run(self._input(a), generator, probes, lmin,
                                lmax)
        return sign, ld

    def logdet(self, a=None, *, generator=None, probes=None, lmin=None,
               lmax=None) -> torch.Tensor:
        """``log|det|`` alone, differentiable in the input (or the
        operator's parameters)."""
        return self.slogdet(a, generator=generator, probes=probes,
                            lmin=lmin, lmax=lmax)[1]

    def value_and_grad(self, a=None, *, generator=None):
        """Forward and backward -> ``(LogdetResult, grad)``.

        ``grad`` is d logabsdet / d input: (n, n) for a matrix, shaped like
        the parameters for an operator (a stencil's bands).  Estimator
        plans draw the probes from ``generator`` (else the config's
        ``seed``) as ``__call__`` does, so the value is the same, and
        report the backward CG's iterations in ``diagnostics.cg_iters``;
        ``wall_time_s`` covers both passes.
        """
        x = self._input(a)
        x = self._check(x, generator, None, None, None)
        tele = _telemetry_start()
        t0 = time.perf_counter()
        with obs.span("plan.backward", method=self.method):
            vag = self._cache.get("vag")
            if vag is None:
                vag = self._cache["vag"] = self._build_vag()
            with torch.no_grad():
                (sign, ld, sem), bar, iters = vag(x, generator)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
            conv = self._telemetry_end(tele)
            if iters is not None:
                obs.observe("cg.iters", iters, method=self.method)
        diags = dataclasses.replace(self.diagnostics, wall_time_s=wall,
                                    cg_iters=iters, convergence=conv)
        return LogdetResult(sign=sign, logabsdet=ld, sem=sem,
                            method_used=self.method, diagnostics=diags), bar

    def _telemetry_end(self, tele: bool):
        """This execution's convergence streams (trace mode), also kept
        for `explain`."""
        if not tele:
            return None
        obs.flush_telemetry()
        conv = obs.drain_telemetry() or None
        if conv:
            self._cache["last_convergence"] = conv
        return conv

    def _build_vag(self) -> Callable:
        return _build_value_and_grad(self.spec, self.method, self.config,
                                     self.device, self._mesh, self._fwd)

    def audit(self, passes=None, include_grad: bool = False):
        """Audit this plan -> `AuditReport` (`repro_torch.analysis`).

        Runs the plan once under the op recorder, on an input made from a
        fixed seed at the plan's shape, dtype and device (and, with
        ``include_grad``, ``value_and_grad`` on it), and runs the
        registered checker passes over the recorded ops: no dense
        factorizations on matrix-free paths, no host read beyond the
        route's entitlement with observability off, collective payloads
        within their analytic bounds, dtype discipline, and stage
        coverage (a second recording under ``REPRO_OBS=trace``).  A mesh
        plan audits on every rank at once.
        """
        from repro_torch.analysis.audit import audit_plan
        return audit_plan(self, pass_ids=passes, include_grad=include_grad)

    def export(self, path: str) -> str:
        """Write this plan's resolved form to ``path`` for
        `repro_torch.load_plan` in another process on the same card and
        kernel build (`repro_torch.serve.aot`).  Runs nothing; mesh and
        operator plans raise `PlanExportError`."""
        from repro_torch.serve.aot import export_plan
        return export_plan(self, path)

    def explain(self) -> str:
        """What this plan resolved to and what it has observed: the spec,
        the config, precision and tiles of an exact plan, the modeled
        cost, the last convergence telemetry (after an execution under
        ``REPRO_OBS=trace``) and the obs state.  No device work.

        The JAX package's lines, but the execution line reads "eager" and
        the device, and there is no ``traces:`` line: nothing is traced.
        """
        spec, d = self.spec, self.diagnostics
        shape = f"n={spec.n}" if spec.batch is None \
            else f"batch={spec.batch} n={spec.n}"
        lines = [
            f"LogdetPlan[{self.method}]",
            f"  spec: {spec.kind} {shape} dtype={spec.dtype} "
            f"structure={spec.structure}",
            f"  config: {self.config}",
            f"  execution: eager on {self.device}, "
            f"devices={d.device_count}"
            + (f", padded {spec.n} -> {d.padded_n}"
               if d.padded_n not in (None, spec.n) else ""),
            f"  modeled cost: flops_est={d.flops_est:.3g}"
            + (f", matvec_cols={d.matvec_cols}"
               if d.matvec_cols is not None else "")
            + (f", backward cg_iters={d.cg_iters}"
               if d.cg_iters is not None else ""),
        ]
        if self.method == "exact" and isinstance(self.config, ExactConfig):
            from repro_torch.kernels.autotune import tile_config
            prec = self.config.precision
            tiles = tile_config(spec.n,
                                itemsize=_torch_dtype(spec.dtype).itemsize,
                                precision=prec)
            lines.insert(3, f"  precision: {prec or 'native'}"
                         + (" (bf16 GEMM operands, full-precision "
                            "accumulators)" if prec == "bf16" else ""))
            lines.insert(4, f"  tiles[{tiles.source}]: "
                         f"panel_k={self.config.k} "
                         f"(autotuned {tiles.panel_k}), "
                         f"block={tiles.block_m}x{tiles.block_n}")
        conv = self._cache.get("last_convergence")
        if conv:
            lines.append("  last convergence (REPRO_OBS=trace):")
            for name, vals in sorted(conv.items()):
                finite = [v for v in vals if math.isfinite(v)]
                final = f"{finite[-1]:.3g}" if finite else "n/a"
                lines.append(
                    f"    {name}: {len(vals)} points, final {final}")
        elif obs.trace_enabled() and self.method not in _EXACT_METHODS:
            lines.append("  last convergence: none recorded yet "
                         "(execute the plan first)")
        if obs.metrics_enabled():
            hits = obs.counter_value("plan.cache.hits")
            misses = obs.counter_value("plan.cache.misses")
            lines.append(f"  obs[{obs.mode()}]: plan cache "
                         f"{hits:g} hits / {misses:g} misses "
                         f"(process-wide)")
        else:
            lines.append("  obs: off (set REPRO_OBS=metrics|trace for "
                         "counters and convergence telemetry)")
        return "\n".join(lines)

    def _run(self, x, generator, probes, lmin, lmax):
        if self.method in _EXACT_METHODS:
            return self._fwd(x)
        return self._fwd(x, generator=generator, probes=probes, lmin=lmin,
                         lmax=lmax)

    def _input(self, a):
        if a is None:
            a = self._bound
        if a is None:
            raise TypeError("this plan was built from a shape spec; pass "
                            "the matrix (or operator) to execute on")
        if self.spec.kind != "operator":
            shape = tuple(getattr(a, "shape", ()))
            want = (self.spec.n, self.spec.n)
            if self.spec.batch is not None:
                want = (self.spec.batch, *want)
            if shape != want:
                raise ValueError(f"plan was built for shape {want}, got "
                                 f"{shape}")
        return a

    def _check(self, x, generator, probes, lmin, lmax):
        """Reject estimator inputs on an exact plan; screen a dense
        estimator input (moved to the plan's device first)."""
        if self.method in _EXACT_METHODS:
            if any(v is not None for v in (generator, probes, lmin, lmax)):
                raise TypeError("exact method takes no generator/probes/"
                                "bounds")
            return x
        if self.spec.kind == "operator":
            return x
        x = torch.as_tensor(x).to(device=self.device,
                                  dtype=getattr(torch, self.spec.dtype))
        if self.validate:
            _validate_spd_like(x, self.method)
        return x


def _telemetry_start() -> bool:
    """In trace mode, drop telemetry buffered before this execution (a
    direct estimator call, another plan) and return True."""
    if not obs.trace_enabled():
        return False
    obs.flush_telemetry()
    obs.drain_telemetry()
    return True


def _validate_spd_like(a: torch.Tensor, method: str) -> None:
    """Necessary-condition SPD screen for a dense estimator input:
    symmetry and a positive diagonal.  The estimators compute tr(log A),
    which is meaningless for non-SPD input; this turns that silent garbage
    into an error.  O(n^2) reductions on the tensor's device; the three
    scalars cross to the host in one read."""
    if a.numel() == 0:
        return
    stats = torch.stack([a.abs().max(), (a - a.transpose(-1, -2)).abs().max(),
                         torch.diagonal(a, dim1=-2, dim2=-1).min()])
    scale, asym, dmin = stats.tolist()                    # the one host read
    scale = scale or 1.0
    # sqrt(eps) * scale: far above the rounding asymmetry of a symmetric
    # product (~n eps), far below any structural asymmetry
    tol = math.sqrt(torch.finfo(a.dtype).eps) * scale
    if asym > tol:
        raise ValueError(
            f"estimator method {method!r} computes tr(log A) and assumes "
            f"symmetric positive-definite input, but the matrix is not "
            f"symmetric (max |A - A^T| = {asym:.3g}). Use method='exact' "
            f"for general matrices, pass validate=False to "
            f"repro_torch.plan to skip this check, or symmetrize the input.")
    if dmin <= 0:
        raise ValueError(
            f"estimator method {method!r} assumes positive-definite input, "
            f"but the diagonal has non-positive entries (min = {dmin:.3g}) "
            f"-- tr(log A) is undefined. Use method='exact' for indefinite "
            f"matrices, or pass validate=False to repro_torch.plan to skip "
            f"this check.")


# --------------------------------------------------------------------------
# the factory + plan cache
# --------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, LogdetPlan]" = OrderedDict()
_PLAN_CACHE_SIZE = 128


def clear_plan_cache():
    """Drop all cached plans (test/debug hook)."""
    _PLAN_CACHE.clear()


def plan(x, *, method: str = "auto", device=None, precision=None,
         config: Optional[LogdetConfig] = None, mesh=None,
         grad: bool = False, validate: bool = True,
         rtol: Optional[float] = None, **kwargs) -> LogdetPlan:
    """Build a log-determinant plan for a problem.

    ``x``          an int N, a shape tuple, a concrete array / tensor, or an
                   operator (concrete inputs stay bound to the plan, so
                   ``plan(a)()`` works).
    ``method``     ``"auto"`` (the cost model, `select_route`, over N,
                   structure, devices, ``rtol`` and the calibration
                   table), ``"exact"`` (the condensation engine, any
                   square matrix), ``"ge"``, ``"pge"``, ``"plu"`` (the
                   Gaussian-elimination baselines, any square matrix;
                   pge and plu need a mesh), ``"chebyshev"`` or ``"slq"``
                   (estimators, SPD input; the only methods an operator
                   takes); the JAX package's legacy route strings
                   (``"mc"``, ``"mc_staged"``, ``"mc_blocked"``, ``"pmc"``,
                   ``"pmc_blocked"``) are deprecated aliases of
                   ``"exact"`` with the schedule and update they pin.
    ``device``     where the plan runs; ``None`` is the card and raises
                   when there is none; ``"cpu"`` runs the plain versions.
                   With a mesh, ``None`` is ``mesh.device``, and another
                   device raises.
    ``precision``  a dtype name casts an array input (``"float64"``,
                   ...); ``"bf16"``/``"bfloat16"`` selects the exact
                   engine's mixed-precision route instead (bf16 GEMM
                   operands, input-dtype buffer and accumulators).
    ``config``     an explicit `ExactConfig` | `ChebyshevConfig` |
                   `SLQConfig`, exclusive with ``**kwargs``.
    ``mesh``       a `repro_torch.core.mesh.Mesh`: distribute one dense
                   matrix over its ranks (exact: the mesh schedule;
                   estimators: a `ShardedOperator`).  Every rank builds
                   and calls the same plan.
    ``grad``       build the ``value_and_grad`` callable now rather than
                   at its first call.
    ``validate``   screen a dense estimator input for symmetry and a
                   positive diagonal at call time.
    ``rtol``       requested relative accuracy; steers ``method="auto"``
                   (below 1e-3 only the exact family qualifies).
    ``**kwargs``   the config's fields (``update=``, ``k=``, ``nb=``,
                   ``degree=``, ``num_probes=``, ``seed=``, ...).  With
                   ``method="auto"`` the estimator knobs inform the cost
                   estimate, and the knobs of the family not picked are
                   dropped; names no method defines still raise.

    Plans for arrays are cached on ``(spec, method, config, device, mesh)``.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.core.mesh.Mesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh.device
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device {device!r} is not the mesh's device "
                             f"{dev} on this rank")
    engine_precision = None
    if precision in ("bf16", "bfloat16"):
        engine_precision = "bf16"
        precision = None
    spec = spec_of(x, dtype=precision)
    if spec.kind == "operator" and (precision is not None
                                    or engine_precision is not None):
        raise ValueError("precision overrides apply to array inputs; cast "
                         "the operator's parameters instead")
    if mesh is not None and spec.batch is not None:
        raise TypeError(
            "mesh sharding applies to a single (n, n) matrix; batched "
            "stacks run one device per matrix -- drop mesh, or map a "
            "single-matrix plan over the stack")
    if getattr(torch, spec.dtype) not in _DTYPES:
        raise TypeError(f"repro_torch plans take float32 or float64 input, "
                        f"got {spec.dtype}")
    if method == "auto":
        if config is not None:
            raise ValueError(
                "method='auto' with an explicit config is ambiguous: the "
                "config pins the method family; pass the method name")
        bounds_known = (kwargs.get("lmin") is not None
                        and kwargs.get("lmax") is not None)
        probes = kwargs.get("num_probes", 32)
        est_cols = (kwargs.get("degree", 64) * probes if bounds_known
                    else kwargs.get("num_steps", 25) * probes + _BOUNDS_COLS)
        method, route = select_route(spec, mesh=mesh, rtol=rtol,
                                     bounds_known=bounds_known,
                                     est_cols=est_cols,
                                     precision=engine_precision)
        kwargs = filter_for_method(method, kwargs)
        if route is not None:
            # the selector's engine tuple, the caller's axes winning; k is
            # the autotuned width exact_cost priced, so auto runs it
            kwargs.setdefault("schedule", route.schedule)
            kwargs.setdefault("update", route.update)
            kwargs.setdefault("k", route.panel_k)
            if route.schedule == "mesh":
                kwargs.setdefault("lookahead", route.lookahead)
    elif method in LEGACY_EXACT_ROUTES:
        schedule, update = LEGACY_ROUTES[method]
        warnings.warn(
            f"exact route string {method!r} is deprecated: it is the "
            f"engine instantiation method='exact', schedule={schedule!r}, "
            f"update={update!r} — request that directly (docs/api.md has "
            f"the route matrix)", DeprecationWarning, stacklevel=2)
        if config is not None:
            if not isinstance(config, ExactConfig):
                raise TypeError(f"method {method!r} needs a ExactConfig, "
                                f"got {type(config).__name__}")
            for axis, val in (("schedule", schedule), ("update", update)):
                got = getattr(config, axis)
                if got not in (None, val):
                    raise TypeError(
                        f"route {method!r} pins {axis}={val!r} but the "
                        f"config says {got!r}; use method='exact' to "
                        f"choose engine axes freely")
            config = dataclasses.replace(config, schedule=schedule,
                                         update=update)
        else:
            for axis, val in (("schedule", schedule), ("update", update)):
                if kwargs.get(axis, val) != val:
                    raise TypeError(
                        f"route {method!r} pins {axis}={val!r}; got "
                        f"{kwargs[axis]!r} — use method='exact' to choose "
                        f"engine axes freely")
            kwargs["schedule"] = schedule
            kwargs["update"] = update
        method = "exact"
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; repro_torch runs "
                         f"{_METHODS}")

    if config is not None:
        if kwargs:
            raise TypeError(
                f"pass knobs either via config= or keywords, not both "
                f"(got config and {sorted(kwargs)})")
        want = type(config_for(method, {}))
        if not isinstance(config, want):
            raise TypeError(f"method {method!r} needs a {want.__name__}, "
                            f"got {type(config).__name__}")
        cfg = config
    else:
        cfg = config_for(method, kwargs)
    if engine_precision is not None:
        if method != "exact":
            raise ValueError(
                f"precision='bf16' is the exact engine's mixed-precision "
                f"route; method {method!r} has no quantized-GEMM path")
        if cfg.precision not in (None, engine_precision):
            raise ValueError(f"precision='bf16' conflicts with config "
                             f"precision {cfg.precision!r}")
        cfg = dataclasses.replace(cfg, precision=engine_precision)
    if method == "exact":
        cfg = cfg.resolved(mesh_present=mesh is not None)
    if spec.kind == "operator":
        if method not in ESTIMATOR_METHODS:
            raise TypeError(f"method {method!r} needs a materialized "
                            f"matrix; operator inputs take an estimator "
                            f"method {ESTIMATOR_METHODS}")
        if mesh is not None:
            raise TypeError("operator inputs carry their own distribution; "
                            "mesh is only accepted for dense array inputs")
    mesh_exact = _is_mesh_exact(method, cfg)
    if mesh_exact and spec.batch is not None:
        raise TypeError(
            f"method {method!r} (mesh schedule) distributes ONE matrix over "
            "the mesh; batched stacks need a serial or staged schedule")
    if mesh_exact and mesh is None:
        raise ValueError("engine schedule 'mesh' requires a mesh"
                         if method == "exact"
                         else f"method {method!r} requires a mesh")
    # a mesh spans its devices only on the routes that distribute: a
    # serial or staged schedule chosen explicitly runs on this rank alone
    run_mesh = mesh if mesh_exact or method in ESTIMATOR_METHODS else None
    devices = run_mesh.size if run_mesh is not None else 1

    key = None
    if spec.kind != "operator":
        key = (spec, method, cfg, str(dev), run_mesh)
        cached = _PLAN_CACHE.get(key)
        obs.inc("plan.cache.hits" if cached is not None
                else "plan.cache.misses")
        if cached is not None:
            _PLAN_CACHE.move_to_end(key)
            if grad and "vag" not in cached._cache:
                cached._cache["vag"] = cached._build_vag()
            if cached.validate != validate or cached.grad != grad:
                cached = dataclasses.replace(cached, validate=validate,
                                             grad=grad)
            return _bind(cached, x)
    if spec.kind == "operator" and not isinstance(x, ProblemSpec):
        x = operator_on(x, dev)         # raises if it cannot be moved
    with obs.span("plan.build", method=method, n=spec.n):
        fwd, padded_n = _build_forward(spec, method, cfg, dev, run_mesh)
        cols, flops = _flops_est(method, spec, cfg, devices)
        p = LogdetPlan(
            spec=spec, method=method, config=cfg, device=dev, grad=grad,
            validate=validate,
            diagnostics=Diagnostics(matvec_cols=cols, flops_est=flops,
                                    padded_n=padded_n, device_count=devices),
            _fwd=fwd, _mesh=run_mesh)
        if grad:
            p._cache["vag"] = p._build_vag()
    obs.set_gauge("plan.flops_est", flops, method=method)
    if key is not None:
        _PLAN_CACHE[key] = p
        while len(_PLAN_CACHE) > _PLAN_CACHE_SIZE:
            _PLAN_CACHE.popitem(last=False)
    return _bind(p, x)


def _bind(p: LogdetPlan, x) -> LogdetPlan:
    """Attach a concrete input to a (possibly shared) plan instance."""
    if hasattr(x, "shape") and not isinstance(x, ProblemSpec):
        return dataclasses.replace(p, _bound=x)
    return p
