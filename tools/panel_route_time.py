"""K4's and K2's card time on the exact panel routes, on one card.

The staged x panel route (`repro_torch.plan(a, method="exact",
update="panel")`) factorizes its K-row panels (K4) at the widths w of
``stage_schedule(n, 0.75, 64)`` and applies each to its (w, w) stage (K2);
the mesh x panel route factorizes every panel at the full width n ((L -
1) // K panels per rank, L = n / P) and applies it to each rank's (L, n)
block, P times per panel a rank owns; with lookahead the owner of the
next panel also applies it to that panel's K rows first (once per panel
after the first it owns: rank 0 one fewer).  This times
``kernels.panel_factor.panel_factor`` on a random f32 (K, w) panel and
``kernels.panel_update.panel_update`` on random f32 operands at each
such shape (CUDA events over 20 launches after 3, queued behind a
sleeping kernel so that the host's enqueue time is hidden:
``tools/card_timing.py``) and sums launches x time per route (rank 0's
on the mesh).  It uses only those wrappers and
``core.engine.stage_schedule``, so the same script, with
``card_timing.py`` beside it, times any tree of the port that has them:

    python3 tools/panel_route_time.py [--n 8192] [--k 32]

Prints the card's name and power limit, one JSON line per shape, then
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
sys.path.insert(0, str(Path(__file__).resolve().parent))

RANKS = (1, 4)              # mesh sizes


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
    from card_timing import queued_ms as time_ms
    from repro_torch.kernels import panel_factor as k4
    from repro_torch.kernels import panel_update as k2

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

    n, k = args.n, args.k
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    staged = staged_panels(n, k)
    k4_ms, k2_ms = {}, {}
    for w in sorted(set(staged) | {n}):
        panel = randn(k, w)
        k4_ms[w] = time_ms(lambda: k4.panel_factor(panel, w))
        print(json.dumps({"kernel": "panel_factor", "shape": [k, w],
                          "ms": k4_ms[w], "staged_launches": staged.get(w, 0)}),
              flush=True)
    mesh_rows = {n // ranks for ranks in RANKS}
    for m, w in sorted({(w, w) for w in staged}
                       | {(rows, n) for rows in mesh_rows} | {(k, n)}):
        a, c, r = randn(m, w), randn(m, k), randn(k, w)
        k2_ms[m, w] = time_ms(lambda: k2.panel_update(a, c, r))
        print(json.dumps({"kernel": "panel_update", "shape": [m, w, k],
                          "ms": k2_ms[m, w],
                          "staged_launches": staged.get(w, 0)
                          if m == w else 0}), flush=True)
        del a, c, r
    routes = {"staged|panel": (sum(c * k4_ms[w] for w, c in staged.items()),
                               sum(c * k2_ms[w, w] for w, c in staged.items()))}
    for ranks in RANKS:
        rows = n // ranks
        panels = (rows - 1) // k
        k2_plain = panels * ranks * k2_ms[rows, n]
        routes[f"mesh{ranks}|panel (rank 0)"] = (panels * k4_ms[n], k2_plain)
        routes[f"mesh{ranks}|panel lookahead (rank 0)"] = (
            panels * k4_ms[n], k2_plain + (panels - 1) * k2_ms[k, n])
    for route, (t4, t2) in routes.items():
        print(json.dumps({"route": route, "k4_card_ms": t4,
                          "k2_card_ms": t2}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
