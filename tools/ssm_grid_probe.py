#!/usr/bin/env python3
"""The SSM grid of `chip_smoke.py` phase 15 at several depths: what it
costs, how well it holds to one rank, and whether its gradient gate
catches a planted fault, to choose LAUNCH_SSM_LAYERS and to show the
gate's power.

    python3 tools/ssm_grid_probe.py [--layers 16 24] [--no-faults]

For each depth: `chip_smoke.ssm_reference` (one rank on the card, and
its first gradient's sensitivity over LAUNCH_SSM_DRAWS draws of
`chip_smoke.reordered`), the 2x2 gloo grid's run through
`chip_smoke.grid_rank` (mamba2-370m at full width, its training steps
and its serving; spawned on its own here, where phase 15 runs it in the
wide grid's rank processes), and `chip_smoke.hold_grid_ssm`, whose
failed gates are printed, not raised.  Then, in the same rank
processes, one step from the same first parameters with a fault planted
(each rank patches the port in its own process, as the CPU tests'
`test_torch_ranks.mutated_split_step` does):

- ``partial_unsummed``: every `PARTIAL` leaf (the SSM blocks' leaves
  but ``out_proj``) reduced over the data line only, each rank keeping
  its part of the model line's sum;
- ``out_proj_unsummed``: every SSM ``out_proj`` gradient left unreduced
  over the data line, each rank keeping its rows' part;

each held by the gradient gate (`chip_smoke.ssm_grad_over`).  Prints a
``depth`` JSON line a depth: the part's seconds as phase 15 pays them
(the reference, the ranks' run without their spawn, the checks), a
rank's step seconds, the first gradient's largest error and sensitivity
(as shares of the largest element, and of each leaf's own), the largest
error over its gate and its leaf, each draw's spread, the served
logits' and caches' errors, the failed gates, and per fault how many of
its faulted leaves the gate flags and the least error over gate among
them; then the card's name and power limit.  Needs a CUDA device and
exits 2 without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C                                   # noqa: E402

FAULTS = ("partial_unsummed", "out_proj_unsummed")


def faulted(name: str, fault: str) -> bool:
    """Whether ``fault`` plants its fault in the leaf ``name``."""
    ssm = ".ssm." in name
    if fault == "partial_unsummed":
        return ssm and not name.endswith(".out_proj")
    return ssm and name.endswith(".out_proj")


@contextlib.contextmanager
def planted(fault: str):
    """The port with ``fault`` planted, in this process (see the module
    docstring)."""
    from repro_torch.sharding import fsdp, layout, tensor
    if fault == "partial_unsummed":
        mod, attr = tensor, "leaf_modes"
        real = tensor.leaf_modes

        def patched(shardings, cfg):
            return {k: tensor.FULL if v == tensor.PARTIAL else v
                    for k, v in real(shardings, cfg).items()}
    elif fault == "out_proj_unsummed":
        mod, attr = fsdp, "reduce"
        real = fsdp.reduce

        def patched(unit, grads, blocks):
            out = real(unit, grads, blocks)
            return [layout.local_block(g.to(b.dtype), unit.plan.gathers[n])
                    if faulted(n, fault) and g is not None else o
                    for n, g, b, o in zip(unit.names, grads, blocks, out)]
    else:
        raise ValueError(fault)
    setattr(mod, attr, patched)
    try:
        yield
    finally:
        setattr(mod, attr, real)


def probe_rank(mesh, argv, layers, ref, faults) -> dict:
    """One rank: `chip_smoke.grid_rank`'s run and serving with its seconds
    (``run_s``), then one step of each of ``faults`` planted, each leaf's
    first gradient's largest difference from ``ref``'s (``faults``)."""
    import torch
    t0 = time.perf_counter()
    out = C.grid_rank(mesh, argv, None, True, layers, True, torch.float32,
                      ref, False, True)
    out["run_s"] = time.perf_counter() - t0
    out["faults"] = {}
    at = argv.index("--ckpt-dir") + 1
    for fault in faults:
        one_step = list(argv)
        one_step[argv.index("--steps") + 1] = "1"
        one_step[at] = f"{argv[at]}_{fault}"
        torch.cuda.empty_cache()
        with planted(fault):
            got = C.grid_rank(mesh, one_step, None, True, layers, True,
                              torch.float32, ref, False, False)
        out["faults"][fault] = got["grad_errs"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[16, 24])
    ap.add_argument("--no-faults", dest="faults", action="store_false")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: ssm_grid_probe.py measures the card",
              file=sys.stderr)
        return 2
    from repro_torch.core.mesh import run_ranks
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    failed: list = []

    def require(cond, msg):
        if not cond:
            failed.append(msg[:400])
    C.require = require
    faults = FAULTS if args.faults else ()
    for layers in args.layers:
        C.LAUNCH_SSM_LAYERS = layers
        failed.clear()
        with tempfile.TemporaryDirectory(prefix="repro_torch_ssm_") as tmp:
            t0 = time.perf_counter()
            one = C.ssm_reference(tmp)
            ref_s = time.perf_counter() - t0
            then = one["then"]
            ranks = run_ranks(probe_rank, C.LAUNCH_GRID[0] * C.LAUNCH_GRID[1],
                              backend="gloo", device="cuda",
                              timeout=C.LAUNCH_WIDE_TIMEOUT,
                              args=(then[0], then[1], then[2], faults))
            t0 = time.perf_counter()
            out = C.hold_grid_ssm(ranks, one, smi)
            hold_s = time.perf_counter() - t0
        run_s = max(r["run_s"] for r in ranks)
        serve = out["serve"]
        planted_out = {}
        for fault in faults:
            over = {k: max(C.ssm_grad_over(r["faults"][fault], one)[k]
                           for r in ranks) for k in one["sens"]}
            hit = [k for k in over if faulted(k, fault)]
            planted_out[fault] = {
                "faulted_leaves": len(hit),
                "flagged": sum(over[k] > 1 for k in hit),
                "least_err_over_gate": min(over[k] for k in hit),
                "least_leaf": min(hit, key=over.get),
                "flagged_elsewhere": sum(over[k] > 1 for k in over
                                         if k not in hit)}
        print("depth", json.dumps({
            "layers": layers, "part_s": ref_s + run_s + hold_s,
            "reference_s": ref_s, "sensitivity_s": one["sensitivity_s"],
            "rank_run_s": run_s, "checks_s": hold_s,
            "rank_step_s": out["rank_step_s"][0],
            "grad_max": ranks[0]["grad_max"],
            "first_grad_err_of_max": out["first_grad_err_of_max"],
            "first_grad_sensitivity_of_max":
                out["first_grad_sensitivity_of_max"],
            "first_grad_sensitivity_of_leaf_max":
                out["first_grad_sensitivity_of_leaf_max"],
            "grad_err_over_gate_max": out["grad_err_over_gate_max"],
            "grad_err_over_gate_worst_leaf":
                out["grad_err_over_gate_worst_leaf"],
            "sensitivity_draw_spread_max":
                out["sensitivity_draw_spread_max"],
            "moved_ops": out["moved_ops"],
            "loss_err_rel": out["loss_err_rel"],
            "logit_err_rel": serve["logit_err_rel"],
            "cache_err_rel": serve["cache_err_rel"],
            "planted": planted_out,
            "failed": list(failed)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
