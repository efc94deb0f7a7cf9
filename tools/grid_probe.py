#!/usr/bin/env python3
"""The full-width train state on a 2x2 grid of gloo ranks sharing one
card, timed per rank, with the card's memory.

    python3 tools/grid_probe.py [--layers 26 6 2] [--optimizer adamw]
        [--steps 2] [--timeout 600] [--log-dir build/grid_probe]

For each ``--layers`` value, four ranks (`core.mesh.run_ranks`, gloo,
one card) each build `launch.train`'s gemma3-1b state at full width cut
to that depth on a ("data", "model") 2x2 grid, then take ``--steps``
mesh steps (`layout.mesh_step`: the parameters gathered one unit at a
time, `sharding.fsdp`; the rank's rows of the batch; each unit's
gradient reduced over the data axis in its backward; its optimizer on
its blocks; its share of the heads, mlp columns and vocab rows on its
model line, `sharding.tensor`), each to a `torch.cuda.synchronize`, with
the rank's peak allocation, the high-water of whole parameter bytes
alive at once (`fsdp.watching`), the shares the rank computed
(`tensor.recording`) and the card's free memory after it, and the
step's collectives by `layout.step_plan` (gathered and summed bytes,
the model line's all_sums and bytes); first the raw
broadcast of a 64 MB and a 512 MB tensor on the card and on the host
over the four ranks.  Each rank appends its progress to
``<log-dir>/rank<r>.log`` as it goes, so a run that stops shows where.
Prints one ``[grid_probe]`` JSON line per depth, then one
``[grid_probe] growth`` line: the growth of rank 0's peak (its last
step's) per added layer between the deepest and the shallowest depth,
beside one layer's f32 bytes; and the card's name and power limit.
About five minutes on an H100 at the default depths.  Needs a CUDA
device and exits 2 without one; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _log(log_dir: str, rank: int, *fields) -> None:
    with open(Path(log_dir) / f"rank{rank}.log", "a") as f:
        print(f"{time.time():.3f}", *fields, file=f, flush=True)


def _broadcast_s(mesh, mb: int) -> dict:
    """Seconds of one broadcast of ``mb`` MB from rank 0, on the card and
    on the host (the second of two calls)."""
    import torch
    from repro_torch.core import mesh as M
    out = {}
    for dev in ("cuda", "cpu"):
        t = torch.ones(mb * 2**18, device=dev)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.broadcast(mesh, t, 0)
            torch.cuda.synchronize()
            out[dev] = time.perf_counter() - t0
    return out


def grid_rank(mesh, layers: int, optimizer: str, steps: int,
              log_dir: str) -> dict:
    """One rank (spawned): see the module docstring."""
    import torch
    from repro_torch.launch import train as T
    from repro_torch.sharding import fsdp, layout, tensor
    from repro_torch.sharding.rules import Sharding, batch_spec
    torch.backends.cuda.matmul.allow_tf32 = False
    r = mesh.rank
    _log(log_dir, r, "start layers", layers, "free",
         torch.cuda.mem_get_info()[0])
    rates = {mb: _broadcast_s(mesh, mb) for mb in (64, 512)}
    _log(log_dir, r, "broadcast s", rates)
    args = T.parser().parse_args(["--arch", "gemma3-1b", "--full",
                                  "--steps", str(steps), "--optimizer",
                                  optimizer])
    grid = T._mesh("2x2", "cuda")
    _, st, step_fn, batch_fn, sh = T.build(
        args.arch, smoke=False, mesh=grid, tcfg=T._tcfg(args), batch=4,
        seq=64, layers=layers)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    _log(log_dir, r, "built resident", resident)
    # one layer's whole parameters in f32 (a unit of the stack)
    layer = sum(4 * math.prod(layout.whole_shape(p.shape, sh["params"][n]))
                for n, p in st["params"].named_parameters()
                if fsdp.unit_of(n) == "blocks.0")
    cfg = st["params"].cfg
    bsh = {k: Sharding(grid, s) for k, s in batch_spec(
        cfg, grid, kind="train", batch=4).items()}
    plan = layout.step_plan(cfg, T._tcfg(args), sh, bsh, layout.whole_like(
        st["params"], sh["params"]), rows=batch_fn(0))
    plan.pop("gathered")
    out = {"rank": r, "coords": grid.coords, "broadcast_s": rates,
           "resident_bytes": resident, "layer_f32_bytes": layer,
           "plan": plan, "steps": []}
    for i in range(steps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with fsdp.watching() as high, tensor.recording() as shares:
            st, m = step_fn(st, batch_fn(i))
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "whole_peak_bytes": high.bytes,
               "whole_peak_units": high.units,
               "shares": {k: sorted(v, key=str) for k, v in shares.items()},
               "card_free_bytes": torch.cuda.mem_get_info()[0],
               "loss": float(m["loss"])}
        out["steps"].append(rec)
        _log(log_dir, r, "step", i, rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[26, 6, 2])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--log-dir", default=str(ROOT / "build" / "grid_probe"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("grid_probe.py needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.mesh import run_ranks
    from repro_torch.kernels import _build
    _build.build()
    Path(args.log_dir).mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    failed = False
    peaks = {}
    for layers in args.layers:
        t0 = time.perf_counter()
        try:
            ranks = run_ranks(grid_rank, 4, backend="gloo", device="cuda",
                              timeout=args.timeout,
                              args=(layers, args.optimizer, args.steps,
                                    args.log_dir))
            rec = {"layers": layers, "optimizer": args.optimizer,
                   "ranks": ranks}
            peaks[layers] = (ranks[0]["steps"][-1]["peak_bytes"],
                             ranks[0]["layer_f32_bytes"])
        except Exception as e:  # noqa: BLE001 -- report, go on
            failed = True
            rec = {"layers": layers, "optimizer": args.optimizer,
                   "error": repr(e)[:2000]}
        rec["seconds"] = time.perf_counter() - t0
        print("[grid_probe]", json.dumps(rec), flush=True)
    if len(peaks) > 1:
        hi, lo = max(peaks), min(peaks)
        growth = (peaks[hi][0] - peaks[lo][0]) / (hi - lo)
        print("[grid_probe] growth", json.dumps({
            "layers": [lo, hi], "peak_bytes": [peaks[lo][0], peaks[hi][0]],
            "per_layer_bytes": growth, "layer_f32_bytes": peaks[hi][1],
            "per_layer_over_layer_f32": growth / peaks[hi][1]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
