#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It fails (nonzero exit, no result line) without a CUDA device, and when
it is not next to the repository's ``src/repro_torch``.  Phases, one
printed line each, any failure ends the run:

1. device   the card's name, and its name and power limit from nvidia-smi;
2. build    nvcc builds K1-K4 from ``src/repro_torch/kernels/csrc``
            (sm_90a), with each kernel's registers, shared memory, spills;
3. kernels  every kernel against its plain PyTorch version on the card,
            at the main path's shapes, in f32, f64 and with bf16 operands:
            bitwise for K1, K3 and K4's R and ls, K4's sign exactly, K4's
            logdet and K2 to the tolerances stated below; then each
            kernel's time beside its plain version, its bound and, where
            one PyTorch call computes the same function, that call;
4. main path ``repro_torch.plan(a, method="exact", ...)`` on the card at
            N = 8192 f32 (the paper's largest size, rounded to the panel
            width) for staged x rank1 and staged x panel, each unfused and
            fused, and staged x panel with bf16 operands: sign exact,
            log|det| against an f64 reference, fused bitwise equal to
            unfused, and the launch counts of K1-K4 equal to the schedule.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

# K4 logdet: the card's log against PyTorch's log, summed over K pivots
LOGDET_RTOL = {"float32": 1e-6, "float64": 1e-14}
# end to end, against the f64 slogdet of the same matrix
E2E_RTOL = {None: 1e-4, "bf16": 5e-3}

KERNEL_META = {
    "rank1_update": ("src/repro_torch/kernels/csrc/condense_step.cu",
                     "src/repro/kernels/condense_step.py:36"),
    "panel_update": ("src/repro_torch/kernels/csrc/panel_update.cu",
                     "src/repro/kernels/panel_update.py:35"),
    "fused_step": ("src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:40"),
    "panel_factor": ("src/repro_torch/kernels/csrc/panel_factor.cu",
                     "src/repro/kernels/panel_factor.py:31"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def time_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
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


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_phase(n: int, k: int, gen) -> dict:
    import torch
    from repro_torch.kernels import condense_step, fused_step, ref
    from repro_torch.kernels import panel_factor as k4
    from repro_torch.kernels import panel_update as k2

    dev = "cuda"
    variants = [(torch.float32, torch.float32), (torch.float64, torch.float64),
                (torch.float32, torch.bfloat16), (torch.float64, torch.bfloat16)]
    timings = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    for dt, op in variants:
        tag = f"{str(dt)[6:]}/{str(op)[6:]}"
        a = randn(n, n, dtype=dt)
        pc, pr = randn(n, dtype=op), randn(n, dtype=op)
        c, r = randn(n, k, dtype=op), randn(k, n, dtype=op)
        l = torch.tensor([n // 3], dtype=torch.int64, device=dev)
        last = n - 1
        col_l, col_last = a[:, n // 3].contiguous(), a[:, last].contiguous()

        # K1, bitwise
        got, want = condense_step.rank1_update(a, pc, pr), \
            ref.rank1_update_ref(a, pc, pr)
        torch.cuda.synchronize()
        err1 = (got - want).abs().max().item()
        require(torch.equal(got, want), f"K1 {tag}: not bitwise, {err1}")

        # K3, bitwise against its plain version and against swap + K1
        got3 = fused_step.fused_step(a, l, last, pc, pr, col_l, col_last)
        want3 = ref.fused_step_ref(a, l, last, pc, pr, col_l, col_last)
        sw = a.clone()
        sw[:, n // 3], sw[:, last] = col_last, col_l
        torch.cuda.synchronize()
        err3 = (got3 - want3).abs().max().item()
        require(torch.equal(got3, want3), f"K3 {tag}: not bitwise, {err3}")
        require(torch.equal(got3, condense_step.rank1_update(sw, pc, pr)),
                f"K3 {tag}: differs from swap + K1")

        # K2: the sums run in another order than cuBLAS's.  Elementwise
        # bound 2*K*eps_acc*(|c|@|r|) + eps_buf*|a - c@r| (the product's
        # rounding in either order, then one rounding of the subtract)
        got2, want2 = k2.panel_update(a, c, r), ref.panel_update_ref(a, c, r)
        acc = ref.accumulator_dtype(dt)
        scale = c.to(acc).abs() @ r.to(acc).abs()
        tol2 = (2 * k * torch.finfo(acc).eps * scale
                + torch.finfo(dt).eps * want2.abs())
        diff2 = (got2 - want2).abs()
        err2 = diff2.max().item()
        require(bool((diff2 <= tol2).all()),
                f"K2 {tag}: outside the summation-order bound, {err2}")
        say("kernels", variant=tag, rank1_update_bitwise=True,
            fused_step_bitwise=True, panel_update_max_abs_err=err2,
            panel_update_max_rel_to_bound=(
                diff2 / tol2.clamp_min(torch.finfo(acc).tiny)).max().item())

        if op == dt:
            # K4: (K, N) panel with all N columns live
            panel = randn(k, n, dtype=dt)
            for r_pos in (0, 1):
                R, ls, s, ld = k4.panel_factor(panel, n, r_pos)
                R0, ls0, s0, ld0 = ref.panel_factor_ref(panel, n, r_pos)
                torch.cuda.synchronize()
                require(torch.equal(R, R0), f"K4 {tag}: R not bitwise")
                require(torch.equal(ls, ls0), f"K4 {tag}: ls differ")
                require(s.item() == s0.item(), f"K4 {tag}: sign differs")
                rel = abs(ld.item() - ld0.item()) / max(abs(ld0.item()), 1e-300)
                require(rel <= LOGDET_RTOL[str(dt)[6:]],
                        f"K4 {tag}: logdet rel err {rel}")
            say("kernels", variant=tag, panel_factor_R_ls_bitwise=True,
                panel_factor_sign_exact=True, panel_factor_logdet_rel=rel,
                logdet_rtol=LOGDET_RTOL[str(dt)[6:]])

        if (dt, op) != (torch.float32, torch.float32):
            continue
        # timings at the main path's dtype (f32)
        it = 4
        name_dt = "float32"
        b1 = (2 * n * n + 2 * n) * it
        b2 = (2 * n * n + n * k + k * n) * it
        b3 = (2 * n * n + 4 * n) * it + 8
        b4 = 2 * k * n * it + k * 8 + 2 * it
        ops4 = k * (n + 2 * k * n + n)     # divide, update, argmax compare
        timings["rank1_update"] = dict(
            max_abs_err=err1,
            ms=time_ms(lambda: condense_step.rank1_update(a, pc, pr)),
            plain_ms=time_ms(lambda: ref.rank1_update_ref(a, pc, pr)),
            library_ms=time_ms(lambda: torch.addr(a, pc, pr, alpha=-1)),
            bound=bound_ms(b1, 2 * n * n, name_dt))
        timings["panel_update"] = dict(
            max_abs_err=err2,
            ms=time_ms(lambda: k2.panel_update(a, c, r)),
            plain_ms=time_ms(lambda: ref.panel_update_ref(a, c, r)),
            library_ms=time_ms(lambda: torch.addmm(a, c, r, alpha=-1)),
            bound=bound_ms(b2, 2 * n * n * k + n * n, name_dt))
        timings["fused_step"] = dict(
            max_abs_err=err3,
            ms=time_ms(lambda: fused_step.fused_step(a, l, last, pc, pr,
                                                     col_l, col_last)),
            plain_ms=time_ms(lambda: ref.fused_step_ref(a, l, last, pc, pr,
                                                        col_l, col_last)),
            library_ms=None,
            bound=bound_ms(b3, 2 * n * n, name_dt))
        panel = randn(k, n, dtype=dt)
        R, _, _, _ = k4.panel_factor(panel, n)
        R0, _, _, _ = ref.panel_factor_ref(panel, n)
        torch.cuda.synchronize()
        timings["panel_factor"] = dict(
            max_abs_err=(R - R0).abs().max().item(),
            ms=time_ms(lambda: k4.panel_factor(panel, n)),
            plain_ms=time_ms(lambda: ref.panel_factor_ref(panel, n),
                             warmup=1, iters=5),
            library_ms=None,
            bound=bound_ms(b4, ops4, name_dt))
        for name, t in timings.items():
            say("timing", kernel=name, shape=[n, n] if name != "panel_factor"
                else [k, n], k=k, ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bound_ms=t["bound"][0],
                bound_by=t["bound"][1])
        del a, pc, pr, c, r, got, want, got2, want2, got3, want3, sw
    return timings


# --------------------------------------------------------------------------
# phase 4: the main path, end to end
# --------------------------------------------------------------------------

def expected_launches(n: int, k: int, update: str, fused: bool) -> dict:
    from repro_torch.core.engine import stage_schedule
    panels = rank1 = 0
    for size, steps in stage_schedule(n, 0.75, 64):
        if size - steps <= 1:           # last stage: blocked or rank-1
            p = (size - 1) // k if update == "panel" and size > k else 0
            panels, rank1 = panels + p, rank1 + size - 1 - p * k
        elif update == "panel" and steps >= k:
            panels, rank1 = panels + steps // k, rank1 + steps % k
        else:
            rank1 += steps
    return {"rank1_update": 0 if fused else rank1,
            "fused_step": rank1 if fused else 0,
            "panel_update": panels, "panel_factor": panels}


def main_path_phase(n: int, k: int, gen) -> dict:
    import torch
    import repro_torch
    from repro_torch.kernels import ops

    x = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    a64 = x @ x.T / n + 2.0 * torch.eye(n, device="cuda", dtype=torch.float64)
    a64[3] = -a64[3]
    a = a64.to(torch.float32).contiguous()
    del x, a64
    s_ref, ld_ref = torch.linalg.slogdet(a.double())
    s_ref, ld_ref = s_ref.item(), ld_ref.item()
    require(s_ref == -1.0, f"reference sign {s_ref}, expected -1")
    a_before = a.clone()

    routes = [("rank1", False, None), ("rank1", True, None),
              ("panel", False, None), ("panel", True, None),
              ("panel", False, "bf16")]
    # warm-up at a small size (cuBLAS handles, allocator) on a matrix of
    # the same family in f64: each route's sign exact and its log|det|
    # against torch.linalg.slogdet and against the same plan on the CPU
    # (f64: rel 1e-10; bf16 operands: the 5e-3 error model); its launches
    # are not counted
    small = 256
    xs = torch.randn(small, small, generator=gen, device="cuda",
                     dtype=torch.float64)
    xs = xs @ xs.T / small + 2.0 * torch.eye(small, device="cuda",
                                             dtype=torch.float64)
    xs[5] = -xs[5]
    ws, wl = (v.item() for v in torch.linalg.slogdet(xs))
    for update, fused, prec in routes:
        tol = 1e-10 if prec is None else E2E_RTOL[prec]
        kw = dict(method="exact", update=update, k=k, fused=fused,
                  precision=prec)
        s, ld = (v.item() for v in repro_torch.plan(xs, **kw)())
        cs, cl = (v.item() for v in repro_torch.plan(xs.cpu(), device="cpu",
                                                     **kw)())
        require(s == ws == cs and abs(ld - wl) <= tol * abs(wl)
                and abs(ld - cl) <= tol * abs(cl),
                f"warm-up {update} fused={fused} {prec}: card ({s}, {ld}), "
                f"cpu ({cs}, {cl}), slogdet ({ws}, {wl})")

    results = {}
    launches = {}
    for update, fused, prec in routes:
        name = f"staged|{update}" + ("|fused" if fused else "") \
            + (f"|{prec}" if prec else "")
        p = repro_torch.plan(a, method="exact", update=update, k=k,
                             fused=fused, precision=prec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = p()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        s, ld = res.sign.item(), res.logabsdet.item()
        rel = abs(ld - ld_ref) / abs(ld_ref)
        want = expected_launches(n, k, update, fused)
        say("main_path", route=name, n=n, sign=s, logabsdet=ld,
            ref_logabsdet=ld_ref, rel_err=rel, rtol=E2E_RTOL[prec],
            wall_s=res.diagnostics.wall_time_s, peak_mem_bytes=peak,
            launches=counts, expected_launches=want)
        require(s == s_ref, f"{name}: sign {s} != {s_ref}")
        require(rel <= E2E_RTOL[prec], f"{name}: rel err {rel}")
        require(counts == want, f"{name}: launches {counts} != {want}")
        results[name] = (res.sign, res.logabsdet)
        launches[name] = counts
    require(torch.equal(a, a_before), "the caller's tensor was modified")
    for update in ("rank1", "panel"):
        u, f = results[f"staged|{update}"], results[f"staged|{update}|fused"]
        require(torch.equal(u[0], f[0]) and torch.equal(u[1], f[1]),
                f"staged|{update}: fused {f[1].item()!r} != unfused "
                f"{u[1].item()!r}")
    say("main_path", fused_equals_unfused_bitwise=True)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8192,
                    help="matrix side of the kernel and main-path phases")
    ap.add_argument("--k", type=int, default=32, help="panel width")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py must sit at the root of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py measures the card and never "
              "falls back to the CPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # phase 2: build
    from repro_torch.kernels import _build
    report = _build.build()
    say("build", dir=report["dir"], cached=report["cached"],
        nvcc_seconds=report["nvcc_seconds"], kernels=report["kernels"])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    # phase 3: kernels against their plain versions, and their times
    timings = kernel_phase(args.n, args.k, gen)
    # phase 4: the main path
    launches = main_path_phase(args.n, args.k, gen)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_route": {r: c[name] for r, c in launches.items()},
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"]})
    say("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
