"""Request coalescing: heterogeneous queue -> homogeneous stacks.

Counterpart of `repro.serve.batching` (the port keeps its own copy, with
the same FIFO rules and rejection messages).  The drain loop pulls
whatever requests are pending and must turn a mixed bag of
``(A, method, rtol)`` into as few plan calls as possible.  `coalesce`
is the pure core of that: it groups requests by ``(bucket, method,
rtol)`` -- everything that can legally share one ``(B, b, b)`` stack --
preserving FIFO admission order both across groups (a group is ordered
by its oldest member) and within a group (results are split back
positionally, so per-request ordering never depends on how the batch
was packed).

Groups larger than ``max_batch`` are split into consecutive chunks; the
batch size of the *plan* is then bucketed separately (`bucket_batch`) so
a 5-request chunk runs through the warm ``B=8`` stack with identity
filler rather than building a ``B=5`` plan.
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.bucket import BucketLadder

__all__ = ["Request", "BatchGroup", "coalesce"]

_ids = itertools.count()


@dataclass
class Request:
    """One admitted logdet request, waiting in the queue."""
    a: np.ndarray                      # validated square (n, n), host-side
    n: int
    bucket: int
    method: str                        # as requested ("auto" allowed)
    rtol: Optional[float]
    future: Future = field(default_factory=Future)
    id: int = field(default_factory=lambda: next(_ids))
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class BatchGroup:
    """Requests that share one padded stack and one plan."""
    bucket: int
    method: str
    rtol: Optional[float]
    requests: List[Request]

    @property
    def oldest(self) -> float:
        return min(r.t_submit for r in self.requests)


def coalesce(requests: Sequence[Request],
             max_batch: int) -> List[BatchGroup]:
    """Group pending requests into homogeneous, FIFO-ordered batches.

    Returns groups sorted by their oldest member's submit time, each at
    most ``max_batch`` long, members in admission order.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    by_key = {}
    for r in sorted(requests, key=lambda r: r.id):
        by_key.setdefault((r.bucket, r.method, r.rtol), []).append(r)
    groups: List[BatchGroup] = []
    for (bucket, method, rtol), members in by_key.items():
        for i in range(0, len(members), max_batch):
            groups.append(BatchGroup(bucket=bucket, method=method,
                                     rtol=rtol,
                                     requests=members[i:i + max_batch]))
    groups.sort(key=lambda g: g.oldest)
    return groups


def admit(a, ladder: BucketLadder, *, method: str,
          rtol: Optional[float], dtype) -> Request:
    """Validate one raw input into a `Request` (raises on bad input)."""
    arr = np.asarray(a, dtype)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        raise ValueError(
            f"expected one square (n, n) matrix per request, got shape "
            f"{arr.shape}; submit stacks as individual requests and let "
            "the server batch them")
    if not np.all(np.isfinite(arr)):
        raise ValueError("matrix contains non-finite entries")
    n = arr.shape[0]
    return Request(a=arr, n=n, bucket=ladder.bucket_for(n),
                   method=method, rtol=rtol)
