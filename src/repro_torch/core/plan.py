"""``repro_torch.plan()`` -- the plan/execute log-determinant API, exact
family.

Counterpart of `repro.core.plan`: the decision of what to run is made
once, at plan time, and the plan is then called on data::

    p = repro_torch.plan(a, method="exact", update="panel")
    sign, logabsdet = p(a)          # LogdetResult, tensors on the card

Plans run on the card unless the caller asks for the CPU: ``device=None``
resolves to ``"cuda"`` and raises when there is none; ``device="cpu"``
runs the plain PyTorch versions of the kernels.  An input on another
device is moved to the plan's device; the caller's tensor is never
modified.

Not ported yet, each raising `NotImplementedError` with its ROADMAP item:
``method="auto"`` and the cost model (Queue 1 item 4), gradients (item 5),
the Gaussian-elimination baseline (item 6), the estimators (item 7), the
mesh schedule, ``pge`` and ``plu`` (item 8), ``explain`` (item 9),
``export`` (item 10), ``audit`` (item 11), the legacy route strings
(item 12), and batched stacks (item 3's remainder).
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.api import pad_to_multiple
from repro_torch.core.configs import ExactConfig, config_for
from repro_torch.core.engine import build_serial
from repro_torch.core.result import Diagnostics, LogdetResult

__all__ = ["plan", "LogdetPlan", "ProblemSpec", "spec_of",
           "clear_plan_cache"]

# methods of the JAX package that the port does not run yet
_NOT_PORTED = {
    "auto": "method='auto' and the cost model (ROADMAP Queue 1 item 4)",
    "ge": "the Gaussian-elimination baseline (ROADMAP Queue 1 item 6)",
    "chebyshev": "the estimators (ROADMAP Queue 1 item 7)",
    "slq": "the estimators (ROADMAP Queue 1 item 7)",
    "pge": "the parallel baselines (ROADMAP Queue 1 item 8)",
    "plu": "the parallel baselines (ROADMAP Queue 1 item 8)",
    **{m: "the legacy route strings (ROADMAP Queue 1 item 12); use "
          "method='exact' with schedule=/update="
       for m in ("mc", "mc_staged", "mc_blocked", "pmc", "pmc_blocked")},
}
_BATCHED_TODO = ("batched (B, n, n) stacks (ROADMAP Queue 1 item 3, "
                 "still open)")
_DTYPES = (torch.float32, torch.float64)


def _not_ported(what: str):
    return NotImplementedError(f"repro_torch does not run {what} yet")


# --------------------------------------------------------------------------
# problem specification
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ProblemSpec:
    """What a plan is built for: ``kind`` "dense" | "batched", the matrix
    side ``n``, the stack size ``batch`` (or None), and the dtype name."""
    kind: str
    n: int
    batch: Optional[int]
    dtype: str


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str) and isinstance(getattr(torch, d, None),
                                         torch.dtype):
        return getattr(torch, d)
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(d))).dtype


def spec_of(x, dtype=None) -> ProblemSpec:
    """Coerce an int N, a shape tuple, an array or a tensor (or an
    existing spec) into a `ProblemSpec`."""
    if isinstance(x, ProblemSpec):
        return x
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
    return ProblemSpec(kind=kind, n=n, batch=batch,
                       dtype=str(dt).removeprefix("torch."))


def _resolve_device(device) -> torch.device:
    """``None`` -> the card; a card must exist unless the CPU is asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch plans run on a CUDA device by default and none "
                "is available; pass device=\"cpu\" to run the plain PyTorch "
                "versions on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} unsupported (cuda or cpu)")
    return dev


# --------------------------------------------------------------------------
# the forward callable
# --------------------------------------------------------------------------

def _serial_exact_core(cfg: ExactConfig) -> Callable:
    ecfg = cfg.engine_config()
    fn = build_serial(ecfg)
    if ecfg.update == "panel":
        # pad so every panel is full; diag(A, I) preserves the result
        k = ecfg.panel_k
        return lambda x: fn(pad_to_multiple(x, k))
    return fn


def _build_forward(spec: ProblemSpec, cfg: ExactConfig,
                   device: torch.device) -> Tuple[Callable, int]:
    """(fwd, padded_n): fwd maps an input to ``(sign, logabsdet)``."""
    padded_n = spec.n
    if cfg.update == "panel" and spec.n:
        padded_n = -(-spec.n // cfg.k) * cfg.k
    core = _serial_exact_core(cfg)
    dtype = getattr(torch, spec.dtype)

    def fwd(a):
        return core(torch.as_tensor(a, dtype=dtype, device=device))

    return fwd, padded_n


# --------------------------------------------------------------------------
# the plan artifact
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LogdetPlan:
    """A log-determinant computation: spec + typed config + device +
    the forward callable.  Build with `repro_torch.plan`; call with data."""
    spec: ProblemSpec
    method: str
    config: ExactConfig
    device: torch.device
    diagnostics: Diagnostics = field(default_factory=Diagnostics)
    _fwd: Callable = field(default=None, repr=False, compare=False)
    _bound: Any = field(default=None, repr=False, compare=False)

    def __call__(self, a=None) -> LogdetResult:
        """Execute the plan -> `LogdetResult` (``wall_time_s`` is taken
        after the card has finished)."""
        x = self._input(a)
        t0 = time.perf_counter()
        sign, ld = self._fwd(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        diags = dataclasses.replace(self.diagnostics, wall_time_s=wall)
        return LogdetResult(sign=sign, logabsdet=ld,
                            sem=torch.zeros_like(ld),
                            method_used=self.method, diagnostics=diags)

    def slogdet(self, a=None):
        """Raw ``(sign, logabsdet)`` pair, no diagnostics, no sync."""
        return self._fwd(self._input(a))

    def logdet(self, a=None) -> torch.Tensor:
        """``log|det|`` alone."""
        return self.slogdet(a)[1]

    def value_and_grad(self, a=None, *, key=None):
        raise _not_ported("gradients (ROADMAP Queue 1 item 5)")

    def audit(self, passes=None, include_grad: bool = False):
        raise _not_ported("the plan audit (ROADMAP Queue 1 item 11)")

    def export(self, path: str) -> str:
        raise _not_ported("AOT plan export (ROADMAP Queue 1 item 10)")

    def explain(self) -> str:
        raise _not_ported("plan explain (ROADMAP Queue 1 item 9)")

    def _input(self, a):
        if a is None:
            a = self._bound
        if a is None:
            raise TypeError("this plan was built from a shape spec; pass "
                            "the matrix to execute on")
        shape = tuple(getattr(a, "shape", ()))
        if shape != (self.spec.n, self.spec.n):
            raise ValueError(f"plan was built for shape "
                             f"{(self.spec.n, self.spec.n)}, got {shape}")
        return a


# --------------------------------------------------------------------------
# the factory + plan cache
# --------------------------------------------------------------------------

_PLAN_CACHE: "OrderedDict[tuple, LogdetPlan]" = OrderedDict()
_PLAN_CACHE_SIZE = 128


def clear_plan_cache():
    """Drop all cached plans (test/debug hook)."""
    _PLAN_CACHE.clear()


def plan(x, *, method: str = "auto", device=None, precision=None,
         config: Optional[ExactConfig] = None, mesh=None,
         grad: bool = False, **kwargs) -> LogdetPlan:
    """Build a log-determinant plan for a problem.

    ``x``          an int N, a shape tuple, or a concrete array / tensor
                   (which stays bound to the plan, so ``plan(a)()`` works).
    ``method``     ``"exact"``, the condensation engine (the only method
                   ported so far).
    ``device``     where the plan runs; ``None`` is the card and raises
                   when there is none; ``"cpu"`` runs the plain versions.
    ``precision``  a dtype name casts the input (``"float64"``, ...);
                   ``"bf16"``/``"bfloat16"`` selects the mixed-precision
                   route instead (bf16 GEMM operands, input-dtype buffer
                   and accumulators) and leaves the input dtype alone.
    ``config``     an explicit `ExactConfig`, exclusive with ``**kwargs``.
    ``**kwargs``   the `ExactConfig` fields (``schedule=``, ``update=``,
                   ``k=``, ``fused=``, ...).

    Plans are cached on ``(spec, method, config, device)``.
    """
    dev = _resolve_device(device)
    engine_precision = None
    if precision in ("bf16", "bfloat16"):
        engine_precision = "bf16"
        precision = None
    spec = spec_of(x, dtype=precision)
    if spec.kind == "batched":
        raise _not_ported(_BATCHED_TODO)
    if getattr(torch, spec.dtype) not in _DTYPES:
        raise TypeError(f"the exact engine takes float32 or float64 input, "
                        f"got {spec.dtype}")
    if mesh is not None:
        raise _not_ported("the mesh schedule (ROADMAP Queue 1 item 8)")
    if grad:
        raise _not_ported("gradients (ROADMAP Queue 1 item 5)")
    if method in _NOT_PORTED:
        raise _not_ported(_NOT_PORTED[method])
    if method != "exact":
        raise ValueError(f"unknown method {method!r}; repro_torch runs "
                         "'exact'")

    if config is not None:
        if kwargs:
            raise TypeError(
                f"pass knobs either via config= or keywords, not both "
                f"(got config and {sorted(kwargs)})")
        if not isinstance(config, ExactConfig):
            raise TypeError(f"method 'exact' needs an ExactConfig, got "
                            f"{type(config).__name__}")
        cfg = config
    else:
        cfg = config_for(method, kwargs)
    if engine_precision is not None:
        if cfg.precision not in (None, engine_precision):
            raise ValueError(f"precision='bf16' conflicts with config "
                             f"precision {cfg.precision!r}")
        cfg = dataclasses.replace(cfg, precision=engine_precision)
    cfg = cfg.resolved()

    key = (spec, method, cfg, str(dev))
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE.move_to_end(key)
        return _bind(cached, x)
    fwd, padded_n = _build_forward(spec, cfg, dev)
    p = LogdetPlan(
        spec=spec, method=method, config=cfg, device=dev,
        diagnostics=Diagnostics(flops_est=(2.0 / 3.0) * spec.n ** 3,
                                padded_n=padded_n, device_count=1),
        _fwd=fwd)
    _PLAN_CACHE[key] = p
    while len(_PLAN_CACHE) > _PLAN_CACHE_SIZE:
        _PLAN_CACHE.popitem(last=False)
    return _bind(p, x)


def _bind(p: LogdetPlan, x) -> LogdetPlan:
    """Attach a concrete input to a (possibly shared) plan instance."""
    if hasattr(x, "shape") and not isinstance(x, ProblemSpec):
        return dataclasses.replace(p, _bound=x)
    return p
