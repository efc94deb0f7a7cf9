"""A 1-D device mesh over `torch.distributed`: one process per rank.

Counterpart of `jax.sharding.Mesh` as the JAX package's mesh schedule and
`ShardedOperator` use it, of `repro._compat.make_mesh` / `axis_size` /
`pvary`, and of the collectives the engine calls inside ``shard_map``
(`lax.axis_index`, `lax.psum`, `lax.all_gather`).

The one structural difference: a JAX mesh is single-controller, one
program sees every device; here every rank is a process of its own.
Every rank calls the same entry point on the same full matrix and gets
the same result; the port slices the rank's row block onto
``mesh.device`` itself.  Estimator probes come from a generator seeded
alike on every rank, so the replicated slabs are identical.

`collective_counts` tallies the collectives this process has issued
through the helpers (the analogue of the kernels' launch counts);
`tallying` also adds up their bytes in its scope, and takes the
collectives that a shape-only run (no process group: the dry run on
meta tensors) would issue, through `tally`.

Only ``broadcast`` and ``all_reduce`` are used, on every backend: NCCL
takes one rank per card, and gloo, which runs several ranks on one card
or on the CPU, takes CUDA tensors for these two collectives alone
(staged through host memory).  The helpers below are exact: a sum over
ranks only ever adds zeros to one rank's value.

`run_ranks` starts the ranks of one mesh as spawned processes (the
analogue of the JAX tests' fake-device subprocesses) and returns their
results.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as _queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "run_ranks", "broadcast", "all_sum",
           "gather_rows", "rank_device", "collective_counts",
           "reset_collective_counts", "tallying", "tally"]

# collectives issued through the helpers below since the last reset
_collectives = {"broadcast": 0, "all_sum": 0}


def collective_counts() -> dict:
    """Collectives this process issued since the last reset, by helper
    (`gather_rows` counts as its P broadcasts)."""
    return dict(_collectives)


def reset_collective_counts() -> None:
    for key in _collectives:
        _collectives[key] = 0


_TALLIES: list = []


@contextlib.contextmanager
def tallying():
    """``{"broadcast", "bytes", "all_sum", "all_sum_bytes"}``: the
    collectives issued in its scope through the helpers below, or
    `tally`'d by a shape-only run, and the bytes of the tensors they
    move (a broadcast's block, an all_sum's tensor)."""
    seen = {"broadcast": 0, "bytes": 0, "all_sum": 0, "all_sum_bytes": 0}
    _TALLIES.append(seen)
    try:
        yield seen
    finally:
        _TALLIES.remove(seen)


def tally(kind: str, t: torch.Tensor) -> None:
    """Count one ``kind`` ("broadcast" or "all_sum") of ``t`` in every
    `tallying` scope (what the helpers do; a shape-only run calls it for
    the collective it stands in for)."""
    key = "bytes" if kind == "broadcast" else "all_sum_bytes"
    for seen in _TALLIES:
        seen[kind] += 1
        seen[key] += t.numel() * t.element_size()


@dataclass(frozen=True)
class Mesh:
    """One 1-D mesh axis over a process group.

    ``size`` ranks, this process being ``rank``; ``device`` is where this
    rank's blocks live (``cuda:<i>``, or ``cpu`` under gloo).  Rank ``p``
    owns rows ``[p L, (p + 1) L)`` of an ``(P L, n)`` matrix.
    """
    group: Any
    size: int
    rank: int
    device: torch.device
    axis_name: str = "rows"

    def block(self, n: int) -> slice:
        """The rows this rank owns of an n-row matrix (n divisible by P)."""
        if n % self.size:
            raise ValueError(f"N={n} not divisible by mesh size {self.size}")
        rows = n // self.size
        return slice(self.rank * rows, (self.rank + 1) * rows)


def rank_device(rank: int, device=None) -> torch.device:
    """The device of ``rank``: ``None`` or ``"cuda"`` is card ``rank mod
    card count`` (one card per rank on a node, or all ranks on card 0 of a
    one-card machine) and raises without a card; ``"cpu"`` is the CPU."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" (with the gloo backend) to "
                "run the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} unsupported (cuda or cpu)")
    return dev


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialized process group (default: the world).

    ``device`` as in `rank_device`.  NCCL needs a card per rank: several
    ranks on one card, or on the CPU, take the gloo backend.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized "
                           "(init_process_group, or run_ranks)")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = rank_device(rank, device)
    if dist.get_backend(group) == "nccl":
        if dev.type != "cuda":
            raise ValueError("the NCCL backend needs a CUDA device per rank")
        if size > torch.cuda.device_count():
            raise ValueError(
                f"NCCL takes one rank per card: {size} ranks, "
                f"{torch.cuda.device_count()} cards; share a card under "
                "the gloo backend")
    return Mesh(group=group, size=size, rank=rank, device=dev)


def _global(mesh: Mesh, src: int) -> int:
    return src if mesh.group is None else dist.get_global_rank(mesh.group,
                                                               src)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int, async_op: bool = False):
    """In place: ``t`` on every rank becomes rank ``src``'s ``t``.  With
    ``async_op`` returns the work handle to ``wait()`` on before ``t`` is
    read."""
    _collectives["broadcast"] += 1
    tally("broadcast", t)
    return dist.broadcast(t, _global(mesh, src), group=mesh.group,
                          async_op=async_op)


def all_sum(mesh: Mesh, t: torch.Tensor, async_op: bool = False):
    """In place: ``t`` becomes the sum of every rank's ``t``; returns it,
    or with ``async_op`` the work handle to ``wait()`` on before ``t`` is
    read."""
    _collectives["all_sum"] += 1
    tally("all_sum", t)
    work = dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group,
                           async_op=async_op)
    return work if async_op else t


def gather_rows(mesh: Mesh, chunk: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """Row-concatenate every rank's ``chunk`` (L, ...) into ``out`` (P L,
    ...) on every rank: P broadcasts, the bytes of an all_gather, which
    gloo does not take for CUDA tensors.  Returns ``out``."""
    rows = chunk.shape[0]
    works = []
    for src in range(mesh.size):
        view = out[src * rows:(src + 1) * rows]
        if src == mesh.rank:
            view.copy_(chunk)
        works.append(broadcast(mesh, view, src, async_op=True))
    for w in works:
        w.wait()
    return out


# --------------------------------------------------------------------------
# starting the ranks of a mesh
# --------------------------------------------------------------------------

def _rank_main(rank: int, world_size: int, backend: str, device,
               init_file: str, timeout: float, fn: Callable, args: tuple,
               results) -> None:
    """One rank: join the group through the file store, run ``fn(mesh,
    *args)``, report ``(rank, ok, value or traceback)``."""
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(make_mesh(device=dev), *args)
            results.put((rank, True, value))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, *, backend: str = "nccl",
              device=None, timeout: float = 300.0, args: tuple = ()) -> List:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, one spawned process
    each, and return the ranks' results in rank order.

    The group is initialized through a `FileStore` in a temporary
    directory: no fixed TCP port, so concurrent runs never collide.  ``fn`` must
    be importable by name (the spawn start method pickles it) and return
    something picklable that holds no CUDA tensor.  Raises if a rank
    fails, with its traceback, or if the ranks have not all finished
    within ``timeout`` seconds; every process is stopped either way.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, device, init_file,
                                   timeout, fn, tuple(args), results),
                             daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict = {}
        failures: list = []
        finished = False
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failures) < world_size:
                left = deadline - time.monotonic()
                if left <= 0 and failures:
                    break
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {world_size - len(got)} of "
                        f"{world_size} ranks unfinished after {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    told = set(got) | {r for r, _ in failures}
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in told]
                    if dead and results.empty():
                        raise RuntimeError(
                            f"run_ranks: rank(s) {dead} exited with "
                            f"{[procs[r].exitcode for r in dead]} and no "
                            "result") from None
                    continue
                if ok:
                    got[rank] = value
                else:
                    # the others' reports follow within moments: the
                    # first failure is not always the cause
                    failures.append((rank, value))
                    deadline = min(deadline, time.monotonic() + 5.0)
            if failures:
                raise RuntimeError("run_ranks: " + "\n".join(
                    f"rank {r} failed:\n{tb}" for r, tb in failures))
            finished = True
        finally:
            for p in procs:
                # a rank that reported is tearing its group down
                p.join(timeout=30 if finished else 0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
            results.join_thread()
    return [got[r] for r in range(world_size)]
