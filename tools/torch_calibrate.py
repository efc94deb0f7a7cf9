#!/usr/bin/env python3
"""Measure the port's roofline calibration table on the card.

The port's counterpart of ``python -m benchmarks.roofline --calibrate``:
it writes the table that `repro_torch.core.calibration` loads and
``method="auto"`` prices routes with, each term measured through what
the port runs for it:

  stream_bytes      K1 (`rank1_update`) on an (n, n) f32 buffer, priced
                    as the JAX package prices it: 3 n^2 itemsize / time
  gemm_flops        K2 (`panel_update`) at (n, n, K), K the autotuned
                    panel width: 2 n^2 K / time; ``gemm_flops_bf16`` the
                    same with bf16 operands
  collective_lat,   `core.mesh.broadcast` of two payloads from a rotating
  collective_bytes  source on RANKS ranks (NCCL with a card per rank,
                    else gloo, the ranks sharing the card), fitted to
                    latency + bytes / bandwidth
  host_rank1_row_s, (median wall of 3 calls - card time of the route's
  host_panel_row_s  kernel launches) / n for staged x rank1 and staged x
                    panel at the autotuned K; the card time is each
                    launch's shape timed alone, behind a sleeping kernel
                    (tools/card_timing.py), times its count

and, printed and kept in the table's ``meta`` (the model has no term for
it), the host time per row of the routes ``method="auto"`` offers a
(B, n, n) stack -- serial x rank1 and serial x panel -- on STACK_CELLS,
for the stack and for one of its matrices: the model charges a stack
``n * host_<update>_row_s``, once per step, since a step runs all B
matrices in one launch and the ops of one matrix; a per-matrix share
would show as the stack's row time above the single matrix's.

Run from the repository root on a machine with a card:

    python3 tools/torch_calibrate.py [--n 8192] [--out PATH]
    python3 tools/torch_calibrate.py --stacks-only

Prints the card's name and power limit and one JSON line per term, and
writes the table (default ``bench_out/torch_roofline_calibration.json``);
``--stacks-only`` measures and prints the stack rows alone and writes
nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

RANKS = 4
PAYLOADS = (256, 65536)          # f32 elements per broadcast
BCAST_STEPS = 200
CALLS = 3
# (B, n): the UBM stack of speaker recognition (2048 components over 60
# features) and a few-but-large one
STACK_CELLS = ((2048, 60), (64, 1024))


def event_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over back-to-back calls."""
    import torch
    for _ in range(warmup):
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


def broadcast_rank(mesh, payloads, steps: int) -> dict:
    """Seconds per broadcast of each payload, the source rotating over the
    ranks as the mesh schedule's owner does (median of 5 loops)."""
    import torch
    from repro_torch.core import mesh as M
    out = {}
    for size in payloads:
        buf = torch.zeros(size, device=mesh.device)
        for _ in range(10):
            M.broadcast(mesh, buf, 0)
        times = []
        for _ in range(5):
            M.all_sum(mesh, torch.zeros(1, device=mesh.device))
            torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            for step in range(steps):
                M.broadcast(mesh, buf, step % mesh.size)
            torch.cuda.synchronize(mesh.device)
            times.append((time.perf_counter() - t0) / steps)
        out[str(size)] = statistics.median(times)
    return out


def measure_collectives(ranks: int):
    import torch
    from repro_torch.core.mesh import run_ranks
    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    raw = run_ranks(broadcast_rank, ranks, backend=backend, device="cuda",
                    timeout=600, args=(PAYLOADS, BCAST_STEPS))[0]
    b1, b2 = (4 * p for p in PAYLOADS)
    t1, t2 = raw[str(PAYLOADS[0])], raw[str(PAYLOADS[1])]
    if t2 <= t1:                        # all latency
        return max(t1, t2), 1e12, raw, backend
    bw = (b2 - b1) / (t2 - t1)
    return max(t1 - b1 / bw, 1e-9), bw, raw, backend


KERNEL_MODULES = {"rank1_update": ("condense_step", "rank1_update"),
                  "panel_update": ("panel_update", "panel_update"),
                  "panel_factor": ("panel_factor", "panel_factor")}


def record_launches(fn) -> Counter:
    """Run ``fn()`` once with the wrappers of K1, K2 and K4 (all the
    unfused exact routes launch) recording the shapes they launch on;
    returns ``Counter((kernel, key))``."""
    import importlib
    seen = Counter()
    saved = []
    for name, (mod_name, attr) in KERNEL_MODULES.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        orig = getattr(mod, attr)

        def wrapper(*args, _orig=orig, _name=name):
            if _name == "panel_factor":
                key = (tuple(args[0].shape), int(args[1]))
            else:
                key = tuple(tuple(a.shape) for a in args[:3])
            seen[_name, key] += 1
            return _orig(*args)

        saved.append((mod, attr, orig))
        setattr(mod, attr, wrapper)
    try:
        fn()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    return seen


def card_ms(launches: Counter, dtype) -> float:
    """Card time of the recorded launches: each shape timed alone on
    random operands behind a sleeping kernel, times its count."""
    import torch
    from card_timing import queued_ms
    from repro_torch.kernels import condense_step, panel_factor, panel_update
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    total = 0.0
    for (name, key), count in launches.items():
        if name == "rank1_update":
            a, pc, pr = (randn(*shape) for shape in key)
            ms = queued_ms(lambda: condense_step.rank1_update(a, pc, pr))
        elif name == "panel_update":
            a, c, r = (randn(*shape) for shape in key)
            ms = queued_ms(lambda: panel_update.panel_update(a, c, r))
        else:
            shape, m0 = key
            p = randn(*shape)
            ms = queued_ms(lambda: panel_factor.panel_factor(p, m0))
        total += count * ms
    return total


def host_term(a, update: str, k: int, schedule: str = "staged") -> dict:
    """(median wall of CALLS calls - card time of the kernels) / n, for
    one matrix or a (B, n, n) stack."""
    import torch
    import repro_torch
    n = a.shape[-1]
    plan = repro_torch.plan(a, method="exact", schedule=schedule,
                            update=update, k=k)
    plan()                                          # warm-up
    walls = [plan().diagnostics.wall_time_s for _ in range(CALLS)]
    launches = record_launches(plan)
    torch.cuda.synchronize()
    card_s = card_ms(launches, a.dtype) / 1e3
    wall = statistics.median(walls)
    return dict(route=f"{schedule}|{update}", shape=list(a.shape), k=k,
                walls_s=walls,
                median_wall_s=wall, kernel_card_s=card_s,
                launches=sum(launches.values()),
                row_s=max(0.0, (wall - card_s) / n))


def stack_host_terms(gen) -> list:
    """The host's time per row of the serial routes on each STACK_CELLS
    stack and on one of its matrices (f32 SPD input), and the share per
    matrix it implies, ``(stack - single) / (B - 1)`` per row."""
    import torch
    from repro_torch.core.calibration import STATIC_DEFAULT
    from repro_torch.kernels.autotune import resolved_panel_k
    out = []
    for b, n in STACK_CELLS:
        x = torch.randn(b, n, n, generator=gen, device="cuda",
                        dtype=torch.float64)
        spd = x @ x.mT / n
        del x
        spd.diagonal(dim1=-2, dim2=-1).add_(2.0)
        spd = spd.to(torch.float32)
        k = resolved_panel_k(n, itemsize=4, cal=STATIC_DEFAULT)
        for update in ("rank1", "panel"):
            stack = host_term(spd, update, k, schedule="serial")
            single = host_term(spd[0].contiguous(), update, k,
                               schedule="serial")
            row = dict(term="stack_host_row_s", route=f"serial|{update}",
                       shape=[b, n, n], k=k, stack_row_s=stack["row_s"],
                       single_row_s=single["row_s"],
                       per_matrix_row_s=(stack["row_s"] - single["row_s"])
                       / (b - 1), stack=stack, single=single)
            print(json.dumps(row), flush=True)
            out.append(row)
        del spd
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--out", default=str(
        ROOT / "bench_out" / "torch_roofline_calibration.json"))
    ap.add_argument("--stacks-only", action="store_true",
                    help="measure and print the stack rows, write nothing")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the table is measured on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core.calibration import STATIC_DEFAULT
    from repro_torch.kernels import _build, condense_step, panel_update
    from repro_torch.kernels.autotune import resolved_panel_k

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    n = args.n
    # the autotuner's width depends on n alone: its terms' rates cancel
    k = resolved_panel_k(n, itemsize=4, cal=STATIC_DEFAULT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.stacks_only:
        stack_host_terms(gen)
        return 0

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    a, pc, pr = randn(n, n), randn(n), randn(n)
    t_r1 = event_ms(lambda: condense_step.rank1_update(a, pc, pr)) / 1e3
    stream = 3.0 * n * n * 4 / t_r1
    print(json.dumps({"term": "stream_bytes", "value": stream,
                      "kernel": "rank1_update", "shape": [n, n],
                      "seconds": t_r1}), flush=True)
    c, r = randn(n, k), randn(k, n)
    t_g = event_ms(lambda: panel_update.panel_update(a, c, r)) / 1e3
    cb, rb = c.to(torch.bfloat16), r.to(torch.bfloat16)
    t_gb = event_ms(lambda: panel_update.panel_update(a, cb, rb)) / 1e3
    gemm, gemm_bf16 = 2.0 * n * n * k / t_g, 2.0 * n * n * k / t_gb
    for term, value, t, op in (("gemm_flops", gemm, t_g, "float32"),
                               ("gemm_flops_bf16", gemm_bf16, t_gb,
                                "bfloat16")):
        print(json.dumps({"term": term, "value": value,
                          "kernel": "panel_update", "shape": [n, n, k],
                          "operands": op, "seconds": t}), flush=True)
    del a, pc, pr, c, r, cb, rb

    x = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    spd = x @ x.T / n
    del x
    spd.diagonal().add_(2.0)
    spd = spd.to(torch.float32)
    hosts = {u: host_term(spd, u, k) for u in ("rank1", "panel")}
    for u, h in hosts.items():
        print(json.dumps({"term": f"host_{u}_row_s", "value": h["row_s"],
                          **h}), flush=True)
    del spd
    torch.cuda.empty_cache()

    stacks = stack_host_terms(gen)
    lat, bw, raw, backend = measure_collectives(RANKS)
    print(json.dumps({"term": "collective", "collective_lat": lat,
                      "collective_bytes": bw, "ranks": RANKS,
                      "backend": backend, "raw_s_per_broadcast": raw}),
          flush=True)

    table = {
        "gemm_flops": gemm, "stream_bytes": stream,
        "collective_lat": lat, "collective_bytes": bw,
        "gemm_flops_bf16": gemm_bf16,
        "host_rank1_row_s": hosts["rank1"]["row_s"],
        "host_panel_row_s": hosts["panel"]["row_s"],
        "source": f"measured:cuda:{torch.cuda.get_device_name(0)}",
        "meta": {
            "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "stream": {"kernel": "rank1_update", "shape": [n, n],
                       "dtype": "float32", "seconds": t_r1},
            "gemm": {"kernel": "panel_update", "shape": [n, n, k],
                     "dtype": "float32", "seconds": t_g},
            "gemm_bf16": {"kernel": "panel_update", "shape": [n, n, k],
                          "dtype": "float32, bf16 operands",
                          "seconds": t_gb},
            "collective": {"helper": "core.mesh.broadcast",
                           "payload_f32": list(PAYLOADS), "ranks": RANKS,
                           "backend": backend,
                           "raw_s_per_broadcast": raw},
            "host": hosts,
            "stacks": [{f: r[f] for f in ("route", "shape", "k",
                                          "stack_row_s", "single_row_s",
                                          "per_matrix_row_s")}
                       for r in stacks],
            "unix_time": time.time(),
        },
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table, indent=2) + "\n")
    print(f"calibration -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
