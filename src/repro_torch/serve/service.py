"""`LogdetService` -- the warm, continuously-batching logdet engine.

Counterpart of `repro.serve.service`.  Ties the pieces together:
admission (`batching.admit`), the bucket ladder, the warm `PlanCache`,
plan preloading from ``plan_dir``, and a single drain thread that
coalesces whatever is pending into homogeneous padded stacks and runs
each through one warm plan::

    with LogdetService(ServeConfig(buckets=(64, 128, 256))) as svc:
        svc.warmup()
        fut = svc.submit(a, method="auto")      # returns a Future
        result = fut.result()                   # per-request LogdetResult

The service runs on the card unless ``ServeConfig(device="cpu")`` asks
for the CPU.  Every request is padded up to a bucket rung and drained
through a plan built at warmup (or loaded from ``plan_dir`` -- see
`repro_torch.serve.aot`), so no request pays for planning.  On the card
an exact ``(B, b, b)`` stack runs staged x rank1 with every step on the
whole stack: K1 launches ``b - 1`` times per batch, whatever B, and the
engine's per-step host dispatch is paid once for the B requests.
Estimator stacks run `BatchedOperator`'s batched products.

The drain is one thread by design: requests queue while a batch
executes and are coalesced when it finishes -- continuous batching,
strict FIFO fairness.  Each batch's ``(B,)`` sign, log|det| and sem cross
to the host in one copy; each request's `LogdetResult` holds numpy
scalars.  A batch's metrics are recorded before any of its futures
resolves, so a client that has its result reads counters that include
it.

Ordering guarantees: admission order is request order (`submit` is the
serialization point); the drain preserves FIFO across groups (oldest
request first) and within a group (results are split back by position).
Completion order across *different* buckets is not guaranteed -- a small
matrix behind a large one may finish first; per-request futures make
that safe.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
# the methods a request may name besides "auto": the JAX package's, the
# deprecated legacy route strings included
from repro_torch.core.configs import METHODS
from repro_torch.core.result import LogdetResult
from repro_torch.estimators import ESTIMATOR_METHODS
from repro_torch.estimators.operators.base import resolve_device
from repro_torch.kernels import _build
from repro_torch.serve.batching import BatchGroup, admit, coalesce
from repro_torch.serve.bucket import (
    DEFAULT_BUCKETS, BucketLadder, PlanCache, bucket_batch, stack_to_bucket,
)

__all__ = ["ServeConfig", "LogdetService", "ServiceClosed", "plan_filename"]


class ServiceClosed(RuntimeError):
    """The service is closed.

    Raised by `LogdetService.submit` after `close()`, and set on the
    futures of requests that were still queued when the drain thread
    stopped -- a queued request must fail loudly, never hang its client.
    """


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs -- everything the deployment tunes.

    ``buckets``        the shape ladder (requests above the top rung are
                       rejected at admission)
    ``max_batch``      largest stack one drain dispatch runs
    ``max_wait_ms``    how long the drain lingers for a batch to fill
                       once at least one request is pending (0 = drain
                       immediately; latency-vs-throughput dial)
    ``cache_capacity`` warm plans kept before LRU eviction
    ``plan_dir``       directory of exported plans to load instead of
                       planning (see ``python -m repro_torch.serve export``)
    ``default_method`` method used when a request does not name one
    ``dtype``          serving dtype; requests are cast on admission
    ``seed``           base of the per-batch estimator generator seeds
    ``device``         where the plans run: None is the card and raises
                       `RuntimeError` when there is none; ``"cpu"`` runs
                       the kernels' plain versions.  Resolved here, to a
                       `torch.device`.
    """
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_batch: int = 16
    max_wait_ms: float = 2.0
    cache_capacity: int = 32
    plan_dir: Optional[str] = None
    default_method: str = "auto"
    dtype: str = "float64"
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.default_method != "auto" and self.default_method not in METHODS:
            raise ValueError(
                f"unknown default_method {self.default_method!r}")
        object.__setattr__(self, "buckets",
                           BucketLadder(self.buckets).buckets)
        object.__setattr__(self, "device", resolve_device(self.device))


def plan_filename(method: str, bucket: int, batch: int, dtype: str) -> str:
    """Canonical artifact name ``python -m repro_torch.serve export``
    writes and the service looks for inside ``plan_dir``."""
    return f"{method}-n{bucket}-B{batch}-{dtype}.repro-torch-plan"


class LogdetService:
    """Bucketed, continuously-batching log-determinant service."""

    def __init__(self, config: Optional[ServeConfig] = None):
        self.config = config if config is not None else ServeConfig()
        self.device = self.config.device
        self.ladder = BucketLadder(self.config.buckets)
        self.plans = PlanCache(capacity=self.config.cache_capacity)
        self._np_dtype = np.dtype(self.config.dtype)
        self._cond = threading.Condition()
        self._pending: list = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._auto: Dict[tuple, str] = {}   # (bucket, rtol) -> method
        self._seed_counter = int(self.config.seed)
        self._seed_lock = threading.Lock()

    # ------------------------------------------------------------ admission

    def submit(self, a, *, method: Optional[str] = None,
               rtol: Optional[float] = None):
        """Admit one ``(n, n)`` matrix; returns a Future[LogdetResult].

        Raises immediately (not via the future) on malformed input:
        non-square, non-finite, or larger than the top bucket rung.
        """
        if self._closed:
            raise ServiceClosed("service is closed")
        m = method or self.config.default_method
        if m != "auto" and m not in METHODS:
            raise ValueError(f"unknown method {m!r}; one of {METHODS} "
                             "or 'auto'")
        req = admit(a, self.ladder, method=m, rtol=rtol,
                    dtype=self._np_dtype)
        obs.inc("serve.requests", method=m)
        obs.observe("serve.request_n", req.n)
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is closed")
            self._ensure_thread()
            self._pending.append(req)
            self._cond.notify()
        return req.future

    def logdet(self, a, *, method: Optional[str] = None,
               rtol: Optional[float] = None,
               timeout: Optional[float] = None) -> LogdetResult:
        """Synchronous convenience wrapper over `submit`."""
        return self.submit(a, method=method, rtol=rtol).result(timeout)

    # ---------------------------------------------------------------- plans

    def _resolve(self, method: str, bucket: int,
                 rtol: Optional[float]) -> str:
        """Pin ``method="auto"`` per (bucket, rtol) -- resolved once, on
        the single-matrix shape, so batching never changes the answer."""
        if method != "auto":
            return method
        key = (bucket, rtol)
        got = self._auto.get(key)
        if got is None:
            from repro_torch.core.plan import select_method
            got = select_method((bucket, bucket), rtol=rtol)
            self._auto[key] = got
        return got

    def _plan_for(self, method: str, bucket: int, batch: int):
        key = (method, bucket, batch, self.config.dtype)
        return self.plans.get(key, lambda: self._build_plan(*key))

    def _build_plan(self, method: str, bucket: int, batch: int,
                    dtype: str):
        if self.config.plan_dir:
            path = os.path.join(self.config.plan_dir,
                                plan_filename(method, bucket, batch, dtype))
            if os.path.exists(path):
                from repro_torch.serve.aot import load_plan
                return load_plan(path, validate=False, device=self.device)
        import repro_torch
        shape = (bucket, bucket) if batch == 1 else (batch, bucket, bucket)
        # the method name alone, as in the JAX package: an exact stack
        # resolves to staged x rank1
        return repro_torch.plan(shape, method=method, precision=dtype,
                                validate=False, device=self.device)

    def warmup(self, methods: Optional[Sequence[str]] = None,
               batches: Optional[Sequence[int]] = None,
               buckets: Optional[Sequence[int]] = None) -> float:
        """Build (or load) and execute every plan the drain can need, on
        identity stacks, so that no request plans or builds a kernel.
        Returns wall seconds spent.

        Defaults: the configured ``default_method``, every bucket rung,
        and the full batch ladder 1, 2, 4, ... ``max_batch``.
        """
        t0 = time.perf_counter()
        methods = list(methods or [self.config.default_method])
        if batches is None:
            batches, b = [], 1
            while b < self.config.max_batch:
                batches.append(b)
                b *= 2
            batches.append(self.config.max_batch)
        with obs.span("serve.warmup"):
            for bucket in (buckets or self.ladder.buckets):
                for m in methods:
                    method = self._resolve(m, bucket, None)
                    for batch in dict.fromkeys(batches):
                        plan = self._plan_for(method, bucket, batch)
                        eye = stack_to_bucket([], bucket, batch,
                                              self._np_dtype)
                        self._execute(plan, method,
                                      eye if batch > 1 else eye[0])
        dt = time.perf_counter() - t0
        obs.set_gauge("serve.warmup_s", dt)
        return dt

    def _next_generator(self) -> torch.Generator:
        """A fresh generator per batch on the service's device, seeded by
        a counter (the JAX package's per-batch key)."""
        with self._seed_lock:
            c = self._seed_counter
            self._seed_counter += 1
        g = torch.Generator(device=self.device)
        g.manual_seed(c)
        return g

    def _execute(self, plan, method: str, x: np.ndarray):
        """One plan call on a host stack (the plan synchronizes the card
        before it returns)."""
        t = torch.from_numpy(x).to(self.device)
        if method in ESTIMATOR_METHODS:
            return plan(t, generator=self._next_generator())
        return plan(t)

    # ---------------------------------------------------------------- drain

    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._drain_loop, name="repro-torch-serve-drain",
                daemon=True)
            self._thread.start()

    def _drain_loop(self):
        wait_s = self.config.max_wait_ms / 1e3
        batch: list = []
        try:
            while True:
                with self._cond:
                    while not self._pending and not self._closed:
                        self._cond.wait()
                    if wait_s > 0 and not self._closed \
                            and len(self._pending) < self.config.max_batch:
                        deadline = time.perf_counter() + wait_s
                        while (len(self._pending) < self.config.max_batch
                               and not self._closed):
                            rem = deadline - time.perf_counter()
                            if rem <= 0:
                                break
                            self._cond.wait(rem)
                    popped, self._pending = self._pending, []
                    done = self._closed and not popped
                if done:
                    # keep `batch` pointing at the last popped work so the
                    # exit cleanup below can still fail anything _run_group
                    # left unresolved (e.g. it was wedged past close())
                    return
                batch = popped
                for group in coalesce(batch, self.config.max_batch):
                    self._run_group(group)
        finally:
            # the drain is stopping -- normally (close) or by a crash
            # outside _run_group's guard (e.g. coalesce).  Whatever is
            # still queued, or popped but unprocessed, must fail loudly
            # instead of leaving forever-pending futures.
            self._fail_queued(batch)

    def _fail_queued(self, extra: Sequence = ()) -> None:
        """Fail every queued (and ``extra``) request with `ServiceClosed`."""
        with self._cond:
            leftovers, self._pending = self._pending, []
        exc = ServiceClosed(
            "service closed before this request was served")
        for r in list(extra) + leftovers:
            if not r.future.done():
                obs.inc("serve.responses", status="closed")
                r.future.set_exception(exc)

    def _run_group(self, g: BatchGroup) -> None:
        # a request its client cancelled is dropped here; the others can
        # no longer be cancelled
        live = [r for r in g.requests if not r.future.done()
                and r.future.set_running_or_notify_cancel()]
        if not live:
            return
        try:
            method = self._resolve(g.method, g.bucket, g.rtol)
            m = len(live)
            batch = bucket_batch(m, self.config.max_batch)
            plan = self._plan_for(method, g.bucket, batch)
            stack = stack_to_bucket([r.a for r in live], g.bucket, batch,
                                    self._np_dtype)
            now = time.perf_counter()
            with obs.span("serve.batch", method=method, bucket=g.bucket,
                          size=m):
                res = self._execute(plan, method,
                                    stack if batch > 1 else stack[0])
            exec_ms = (time.perf_counter() - now) * 1e3
            # one device-to-host copy for the whole batch
            signs, lds, sems = torch.stack(
                [v.reshape(-1) for v in (res.sign, res.logabsdet, res.sem)]
            ).cpu().numpy()
            diags = dataclasses.replace(res.diagnostics, padded_n=g.bucket)
            results = [LogdetResult(sign=signs[i], logabsdet=lds[i],
                                    sem=sems[i], method_used=res.method_used,
                                    diagnostics=diags)
                       for i in range(m)]
            # the metrics first: a client that holds its result must see
            # them
            for r in live:
                obs.observe("serve.queue_wait_ms", (now - r.t_submit) * 1e3)
                obs.observe("serve.pad_ratio", g.bucket / r.n)
            obs.inc("serve.batches", method=method, bucket=g.bucket)
            obs.inc("serve.responses", m, status="ok")
            obs.observe("serve.batch_size", m)
            obs.observe("serve.batch_fill", m / batch)
            obs.observe("serve.exec_ms", exec_ms, bucket=g.bucket)
        except Exception as exc:           # noqa: BLE001 -- fail the futures
            obs.inc("serve.responses", len(live), status="error")
            for r in live:
                r.future.set_exception(exc)
            return
        for r, out in zip(live, results):
            r.future.set_result(out)

    # ------------------------------------------------------------ lifecycle

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain remaining requests, then stop the drain thread.

        Requests still queued when the drain stops -- it crashed earlier,
        or ``timeout`` expired with it wedged -- get `ServiceClosed` set
        on their futures; `submit` raises `ServiceClosed` from now on.
        """
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # normally the drain already failed its own leftovers on exit;
        # this covers a wedged or previously-crashed thread
        self._fail_queued()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- intro

    def stats(self) -> dict:
        """JSON-friendly operational snapshot (served at ``GET /stats``).

        The JAX package's keys, without ``trace_count`` (nothing is
        traced), with ``device`` and ``kernel_loads``: how many times this
        process has loaded the kernels' libraries (`kernels._build.loads`;
        1 on the card once warmup has run, 0 on the CPU)."""
        snap = obs.snapshot()
        serve_counters = {k: v for k, v in snap["counters"].items()
                          if k.startswith("serve.")}
        return {
            "buckets": list(self.ladder.buckets),
            "max_batch": self.config.max_batch,
            "max_wait_ms": self.config.max_wait_ms,
            "dtype": self.config.dtype,
            "device": str(self.device),
            "kernel_loads": _build.loads,
            "plans_cached": len(self.plans),
            "plan_keys": ["|".join(map(str, k)) for k in self.plans.keys()],
            "auto_resolution": {f"n{b}" + (f"@rtol={r}" if r else ""): m
                                for (b, r), m in sorted(self._auto.items())},
            "pending": len(self._pending),
            "counters": serve_counters,
            "quantiles": {
                name: {"p50": obs.quantile(name, 0.5),
                       "p99": obs.quantile(name, 0.99)}
                for name in ("serve.queue_wait_ms", "serve.batch_size")
            },
        }
