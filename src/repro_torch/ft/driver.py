"""The fault-tolerant training driver -- counterpart of `repro.ft.driver`:
restart on failure, periodic (async) checkpoints, straggler detection and
deterministic data replay.

The driver owns the outer Python loop.  On ANY exception from a step
(device loss, preemption signal, injected test fault) it:
  1. waits for pending async checkpoint writes,
  2. restores the latest checkpoint onto the device the state lives on,
     or, with none saved yet, goes on from the state it holds (the train
     step leaves it as it was when it raises before its commit point,
     `repro_torch.train.step`),
  3. replays the data stream from the restored step (``batch_fn`` is a
     pure function of the step),
  4. continues, up to ``max_restarts``.

Straggler detection: per-step wall times (to a sync on the loss's
device) feed an EWMA seeded from the second measured step; a step slower
than ``straggler_factor`` x EWMA is recorded with its index.
``on_metrics`` receives the metrics as Python floats after one
device-to-host copy a step.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt

__all__ = ["FTConfig", "StepStats", "run_training"]


@dataclass
class FTConfig:
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 50
    async_ckpt: bool = True
    max_restarts: int = 3
    straggler_factor: float = 2.5
    ewma: float = 0.9


@dataclass
class StepStats:
    times: List[float] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    restarts: int = 0


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, through one device-to-host copy."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().to(torch.float64).reshape(())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def run_training(
    *,
    state: Any,
    train_step: Callable[[Any, Any], tuple],
    batch_fn: Callable[[int], Any],
    n_steps: int,
    ft: Optional[FTConfig] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
    fault_injector: Optional[Callable[[int], None]] = None,
) -> tuple[Any, StepStats]:
    """Run up to step ``n_steps`` with checkpoint/restart fault tolerance.

    ``batch_fn(step)`` must be deterministic in ``step`` (replayable).
    ``fault_injector(step)`` (tests) may raise to simulate a node failure
    or sleep to simulate a straggler.
    """
    ft = FTConfig() if ft is None else ft
    stats = StepStats()
    step = int(state["step"])
    ewma_t: Optional[float] = None

    while step < n_steps:
        try:
            t0 = time.perf_counter()
            if fault_injector is not None:    # inside the timed window: an
                fault_injector(step)          # injected sleep IS a straggler
            state, metrics = train_step(state, batch_fn(step))
            if metrics["loss"].device.type == "cuda":
                torch.cuda.synchronize(metrics["loss"].device)
            dt = time.perf_counter() - t0
            stats.times.append(dt)
            if ewma_t is not None and dt > ft.straggler_factor * ewma_t:
                stats.stragglers.append(step)
            # seed the EWMA from the SECOND measured step: the first one
            # carries the warm-up (kernel builds, allocator growth)
            if len(stats.times) == 2:
                ewma_t = dt
            elif ewma_t is not None:
                ewma_t = ft.ewma * ewma_t + (1 - ft.ewma) * dt
            step += 1
            if on_metrics is not None:
                on_metrics(step, _to_host(metrics))
            if step % ft.ckpt_every == 0 or step == n_steps:
                if ft.async_ckpt:
                    ckpt.save_async(ft.ckpt_dir, state, step)
                else:
                    ckpt.save(ft.ckpt_dir, state, step)
        except (KeyboardInterrupt,):
            raise
        except Exception as e:          # noqa: BLE001 -- the FT boundary
            stats.restarts += 1
            if stats.restarts > ft.max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={ft.max_restarts}") from e
            ckpt.wait_pending()
            last = ckpt.latest_step(ft.ckpt_dir)
            if last is None:
                # nothing saved yet: go on from the state held
                step = int(state["step"])
                continue
            state, step = ckpt.restore(ft.ckpt_dir, state, step=last,
                                       device=state["step"].device)

    ckpt.wait_pending()
    return state, stats
