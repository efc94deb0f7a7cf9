"""K4's card time on the exact panel routes, width by width, on one card.

The staged x panel route (`repro_torch.plan(a, method="exact",
update="panel")`) factorizes its K-row panels at the widths of
``stage_schedule(n, 0.75, 64)``; the mesh x panel route factorizes every
panel at the full width n ((L - 1) // K panels per rank, L = n / P).
This times ``kernels.panel_factor.panel_factor`` on a random f32 (K, w)
panel at each such width (CUDA events, 20 launches after 3) and sums
launches x time per route.  It uses only that wrapper and
``core.engine.stage_schedule``, so the same script times any tree of the
port that has them:

    python3 tools/panel_route_time.py [--n 8192] [--k 32]

Prints the card's name and power limit, one JSON line per width, then
one per route (ms).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def staged_panels(n: int, k: int) -> Counter:
    """Panels of the staged x panel route by width (as chip_smoke.py's
    expected_launches counts them)."""
    from repro_torch.core.engine import stage_schedule
    count = Counter()
    for size, steps in stage_schedule(n, 0.75, 64):
        if size - steps <= 1:
            count[size] += (size - 1) // k if size > k else 0
        elif steps >= k:
            count[size] += steps // k
    return +count


def main() -> int:
    import torch
    from repro_torch.kernels import panel_factor as k4

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--k", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    n, k = args.n, args.k
    gen = torch.Generator(device="cuda").manual_seed(0)
    staged = staged_panels(n, k)
    ms = {}
    for w in sorted(set(staged) | {n}):
        panel = torch.randn(k, w, generator=gen, device="cuda")
        ms[w] = time_ms(lambda: k4.panel_factor(panel, w))
        print(json.dumps({"width": w, "k": k, "ms": ms[w],
                          "staged_launches": staged.get(w, 0)}), flush=True)
    routes = {"staged|panel": sum(c * ms[w] for w, c in staged.items())}
    for ranks in (1, 4):
        panels = (n // ranks - 1) // k
        routes[f"mesh{ranks}|panel (rank 0)"] = panels * ms[n]
    for route, total in routes.items():
        print(json.dumps({"route": route, "k4_card_ms": total}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
