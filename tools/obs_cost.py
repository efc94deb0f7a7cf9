#!/usr/bin/env python3
"""What observability costs the exact routes with ``REPRO_OBS`` off.

Compares this tree with an earlier one on one card, in one process:

    git archive <commit> | tar -x -C build/parent
    python3 tools/obs_cost.py --parent build/parent [--pairs 10]

It imports the earlier tree's ``repro_torch``, builds its plans, then
imports this tree's (the modules of the first stay alive in its plans)
and calls chip_smoke.py phase 4's staged x rank1 and staged x panel (K =
32) on its exact cell (x x^T / N + 2 I, row 3 negated, f32) in PAIRS
pairs, parent then change and change then parent in turns (so the order
runs parent, change, change, parent, ...), each call's wall taken after
the card synchronized.  Per route it prints both walls' medians and
quartiles, the ratio of the medians and the pairs the change won; and
the host time per row, ``(median wall - card time of the route's
kernels) / N`` (tools/torch_calibrate.py's ``host_rank1_row_s`` /
``host_panel_row_s``, at K = 32), the card time measured once.  Then what
the disabled hooks themselves cost: one no-op `obs.stage` and one
`obs.inc` timed alone, times the hooks a row of staged x rank1 (four
stages, one counter) and a panel of staged x panel (four stages, two
counters) enter.  Card only; ``REPRO_OBS`` must be unset or off.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HOOK_CALLS = 200_000
ROUTES = ("rank1", "panel")
K = 32


def load_port(root: Path):
    """``repro_torch`` from ``root``'s ``src``, after dropping any loaded
    one from ``sys.modules`` (its objects keep their own modules)."""
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        port = importlib.import_module("repro_torch")
        importlib.import_module("repro_torch.kernels._build").build()
    finally:
        sys.path.remove(str(root / "src"))
    return port


def exact_cell(n: int):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a = x @ x.T / n
    del x
    a.diagonal().add_(2.0)
    a[3] = -a[3]
    return a.to(torch.float32).contiguous()


def wall(p) -> float:
    return p().diagnostics.wall_time_s


def hook_costs(obs) -> dict:
    """Seconds of one disabled ``obs.stage`` (enter and exit) and one
    disabled ``obs.inc``, with the keywords the kernels pass."""
    t0 = time.perf_counter()
    for _ in range(HOOK_CALLS):
        with obs.stage("kernel.rank1_update", backend="cuda"):
            pass
    t1 = time.perf_counter()
    for _ in range(HOOK_CALLS):
        obs.inc("kernel.dispatch", op="rank1_update", backend="cuda")
    t2 = time.perf_counter()
    stage, inc = (t1 - t0) / HOOK_CALLS, (t2 - t1) / HOOK_CALLS
    return {"stage_s": stage, "inc_s": inc, "rank1_row_s": 4 * stage + inc,
            "panel_s": 4 * stage + 2 * inc}


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return [q[0], q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the earlier tree")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--n", type=int, default=8192)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the costs are measured on the card",
              file=sys.stderr)
        return 2
    if os.environ.get("REPRO_OBS", "off") != "off":
        print("unset REPRO_OBS: this measures obs off", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    a = exact_cell(args.n)
    plans = {}
    for tree, root in (("parent", Path(args.parent).resolve()),
                       ("change", ROOT)):
        port = load_port(root)
        for update in ROUTES:
            plans[tree, update] = port.plan(a, method="exact",
                                            update=update, k=K)
            wall(plans[tree, update])                     # warm-up
    walls = {key: [] for key in plans}
    wins = dict.fromkeys(ROUTES, 0)
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for update in ROUTES:
            got = {tree: wall(plans[tree, update]) for tree in order}
            for tree, w in got.items():
                walls[tree, update].append(w)
            wins[update] += got["change"] < got["parent"]
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_calibrate
    from repro_torch import obs
    out = {"n": args.n, "k": K, "pairs": args.pairs}
    for update in ROUTES:
        card_s = torch_calibrate.card_ms(torch_calibrate.record_launches(
            plans["change", update]), a.dtype) / 1e3
        row = {"card_s": card_s, "change_wins": wins[update]}
        for tree in ("parent", "change"):
            w = walls[tree, update]
            row[tree] = {"median_s": statistics.median(w),
                         "quartiles_s": quartiles(w), "walls_s": w,
                         "host_row_s": (statistics.median(w) - card_s)
                         / args.n}
        row["ratio_of_medians"] = (row["change"]["median_s"]
                                   / row["parent"]["median_s"])
        out[f"staged|{update}"] = row
    obs.configure("off")
    hooks = hook_costs(obs)
    hooks["rank1_share_of_host_row"] = hooks["rank1_row_s"] / out[
        "staged|rank1"]["change"]["host_row_s"]
    hooks["panel_share_of_host_panel"] = hooks["panel_s"] / (
        K * out["staged|panel"]["change"]["host_row_s"])
    out["off_hooks"] = hooks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
