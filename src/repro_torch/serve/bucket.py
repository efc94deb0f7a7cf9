"""Shape bucketing: the pad-to-bucket policy and the warm plan cache.

Counterpart of `repro.serve.bucket` (numpy there too; the port keeps its
own copy, with the same names and semantics).  With sizes drawn from
[64, 512] nearly every request has a shape of its own.  Requests are
padded up to a **bucket ladder**: a short ascending list of sizes, each
served by a handful of warm plans.  Padding embeds ``A`` as
``diag(A, I)``, which preserves ``slogdet`` exactly (the identity block
contributes sign ``+1`` and ``log|det| = 0``), and adds only unit
eigenvalues -- harmless to the SPD estimators too.  On the card the
point is the stack: one ``(B, b, b)`` plan pays the engine's per-step
host dispatch once for B requests.

Batch sizes are bucketed the same way (1, 2, 4, ... ``max_batch``) so a
drain of 5 requests reuses the warm ``B=8`` plan with identity filler
matrices instead of building a ``B=5`` one.

`PlanCache` is the LRU of warm plans, keyed by whatever tuple the caller
chooses (the service uses ``(method, bucket, batch, dtype)``).  Eviction
drops the oldest-touched plan; hits, misses and evictions are counted in
`repro_torch.obs` as ``serve.plan_cache.*``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

__all__ = ["DEFAULT_BUCKETS", "BucketLadder", "PlanCache",
           "bucket_batch", "pad_to_bucket", "stack_to_bucket"]

# covers the mixed-request regime the benchmarks exercise (N in 64..512)
# with one rung of headroom; tune per deployment via ServeConfig.buckets
DEFAULT_BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024)


@dataclass(frozen=True)
class BucketLadder:
    """Ascending rung sizes; every request is padded up to its rung."""
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        rungs = tuple(sorted({int(b) for b in self.buckets}))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"need at least one positive bucket size, "
                             f"got {self.buckets!r}")
        object.__setattr__(self, "buckets", rungs)

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n.  Raises for n above the top rung -- a
        serving deployment must size its ladder for its traffic rather
        than silently build unbounded plans."""
        if n < 1:
            raise ValueError(f"matrix size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"matrix size {n} exceeds the top bucket {self.max}; add a "
            f"rung to the ladder (buckets={self.buckets})")


def bucket_batch(m: int, max_batch: int) -> int:
    """Smallest power-of-two batch >= m, capped at ``max_batch``."""
    if m < 1:
        raise ValueError(f"batch must be >= 1, got {m}")
    if m >= max_batch:
        return max_batch
    b = 1
    while b < m:
        b *= 2
    return min(b, max_batch)


def pad_to_bucket(a: np.ndarray, bucket: int,
                  dtype=np.float64) -> np.ndarray:
    """Embed one ``(n, n)`` matrix as ``diag(a, I)`` of size bucket."""
    n = a.shape[-1]
    if n > bucket:
        raise ValueError(f"matrix size {n} exceeds bucket {bucket}")
    out = np.zeros((bucket, bucket), dtype)
    out[:n, :n] = a
    if n < bucket:
        idx = np.arange(n, bucket)
        out[idx, idx] = 1.0
    return out


def stack_to_bucket(mats: Sequence[np.ndarray], bucket: int, batch: int,
                    dtype=np.float64) -> np.ndarray:
    """Pad each matrix to ``bucket`` and stack to ``(batch, b, b)``.

    Unused slots (``len(mats) < batch``) are identity matrices -- their
    log-determinants are exactly 0 and are discarded on the way out.
    """
    if len(mats) > batch:
        raise ValueError(f"{len(mats)} matrices exceed batch {batch}")
    out = np.zeros((batch, bucket, bucket), dtype)
    idx = np.arange(bucket)
    out[:, idx, idx] = 1.0
    for i, a in enumerate(mats):
        n = a.shape[-1]
        out[i] = 0.0
        out[i, :n, :n] = a
        if n < bucket:
            tail = np.arange(n, bucket)
            out[i, tail, tail] = 1.0
    return out


@dataclass
class PlanCache:
    """LRU cache of warm plans (or any expensive keyed artifact).

    ``get(key, builder)`` returns the cached value, or builds, inserts
    and possibly evicts.  Thread-safe; the builder runs outside the lock
    is NOT guaranteed -- the serve drain is single-threaded, and double
    builds are merely wasteful, never incorrect.
    """
    capacity: int = 32
    _lru: "OrderedDict[tuple, object]" = field(default_factory=OrderedDict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def keys(self):
        with self._lock:
            return list(self._lru)

    def get(self, key: tuple, builder: Optional[Callable] = None):
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                obs.inc("serve.plan_cache.hits")
                return self._lru[key]
        obs.inc("serve.plan_cache.misses")
        if builder is None:
            return None
        value = builder()
        self.put(key, value)
        return value

    def put(self, key: tuple, value) -> None:
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                old_key, _ = self._lru.popitem(last=False)
                obs.inc("serve.plan_cache.evictions")
                obs.set_gauge("serve.plan_cache.size", len(self._lru))
            obs.set_gauge("serve.plan_cache.size", len(self._lru))
