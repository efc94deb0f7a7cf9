#!/usr/bin/env python3
"""Where `chip_smoke.py` phase 15's full-width runs spend their seconds:
the 26-layer 2x2 grid (`chip_smoke.launch_grid_wide`) and `launch.train`
at full width on one rank (`chip_smoke.launch_full`), with timers around
their parts.

    python3 tools/launch_timing.py

In every rank of the grid: the build (`launch.train.build`), the loop
(`launch.train._drive`: the steps and the checkpoint), the checkpoint's
gather and host copy (`checkpoint._host_leaves`), its write
(`checkpoint._write`, rank 0) and the wait for it
(`checkpoint.wait_pending`), every `layout.gather_leaf`, the host copies
of `launch.train._host`, `layout.step_plan`, the steps' own seconds and
the rank's total.  In this process: the one-rank reference
(`chip_smoke._one_rank`), its checkpoint's host copy and write, the
reference gradients' file (`numpy.savez`), `chip_smoke.hold_grid`, and
each `core.mesh.run_ranks`.  Prints a ``wide`` and a ``full`` JSON line
(seconds), then the card's name and power limit.  About five minutes on
an H100.  Needs a CUDA device and exits 2 without one.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np                                       # noqa: E402

import chip_smoke                                        # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt    # noqa: E402
from repro_torch.core import mesh as core_mesh           # noqa: E402
from repro_torch.launch import train as T                # noqa: E402
from repro_torch.sharding import layout                  # noqa: E402

SPENT: dict = {}


def timed(mod, name: str, key: str, into: dict) -> None:
    """Replace ``mod.name`` by a wrapper adding its seconds to
    ``into[key]``."""
    real = getattr(mod, name)

    @functools.wraps(real)
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            into[key] = into.get(key, 0.0) + time.perf_counter() - t0
    setattr(mod, name, wrapped)


# in every process, the spawned ranks too (they import this module)
for _mod, _name in ((T, "build"), (T, "_drive"), (T, "_host"),
                    (ckpt, "_host_leaves"), (ckpt, "_write"),
                    (ckpt, "wait_pending"), (layout, "gather_leaf"),
                    (layout, "step_plan")):
    timed(_mod, _name, _name, SPENT)
GRID_RANK = chip_smoke.grid_rank


def timed_rank(*a, **k) -> dict:
    """`chip_smoke.grid_rank` with the rank's seconds (``spent``)."""
    t0 = time.perf_counter()
    SPENT.clear()
    out = GRID_RANK(*a, **k)
    out["spent"] = dict(SPENT, total=time.perf_counter() - t0,
                        steps=sum(out["step_s"]))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: launch_timing.py measures the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    chip_smoke.grid_rank = timed_rank
    here: dict = {}
    for mod, name in ((np, "savez"), (chip_smoke, "_one_rank"),
                      (chip_smoke, "hold_grid")):
        timed(mod, name, name, here)
    real_run_ranks = core_mesh.run_ranks

    def run_ranks(fn, *a, **k):
        t0 = time.perf_counter()
        out = real_run_ranks(fn, *a, **k)
        here.setdefault("run_ranks", []).append(
            {"fn": fn.__name__, "s": time.perf_counter() - t0,
             "ranks": [r.get("spent") for r in out]})
        return out
    core_mesh.run_ranks = run_ranks
    for line, fn in (("wide", chip_smoke.launch_grid_wide),
                     ("full", chip_smoke.launch_full)):
        SPENT.clear()
        here.clear()
        t0 = time.perf_counter()
        out = fn("launch_timing")
        print(line, json.dumps(dict(here, main=dict(SPENT),
                                    total=time.perf_counter() - t0,
                                    run_s=out.get("run_s"),
                                    checkpoint=out.get("checkpoint"))),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
