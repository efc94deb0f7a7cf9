"""Time K7 (``csrc/cg_step.cu``) against variants of its design and an
earlier tree's kernel, and sum it over the dense CG route, on one NVIDIA
card.

A variant is the shipped kernel launched with another cut than
``matvec.plan`` gives (the C entry takes any consistent cut: the
reduction axis in one, two or four ranges), the shipped source with one
design choice changed by a text substitution (SOURCE_VARIANTS, each must
apply; built by nvcc with the package's flags into
``build/k7_variants/<name>/``, all builds started together), or K5
(``matvec.matvec``) followed by the plain epilogue of
``ref.cg_step_ref``.  Each ``--parent [NAME=]DIR`` adds the kernel ``DIR/cg_step.cu`` of an earlier tree, built against the
headers beside it with the earlier C signature (partials of one row per
32 rows): point it at the ``csrc`` directory of that tree (``git archive
<commit> | tar -x -C build/parent`` unpacks one where nothing is
committed).

Checks before any timing: every variant and parent within twice
``ref.cg_step_bound`` of the plain version at K7_CHECK and at (EST_N,
PROBES), in f32 and f64, on aligned matrices and on rows 1.. of an (n +
1, n) one (not 16-byte aligned); a column with p = 0 an exact no-op; a
repeated call of the shipped K7 bitwise equal.

    python3 tools/k7_variants.py [--parent [NAME=]DIR ...]

Prints the card's name and power limit, then one JSON line per build
(ptxas: registers, shared memory, spills), per check and per timed
shape: ms per launch on the card, 50 launches queued behind a sleeping
kernel so that the host's enqueue time is hidden (``card_timing.py``),
beside the product alone on the same operands, by K5 (``matvec``) and
by cuBLAS (``matmul``, ``a @ p``), the plain version (``plain``) and
``bound_ms`` by bytes at 3.35 TB/s.  Then the dense CG
route (``estimators.cg_solve`` on ``chip_smoke.py``'s dense cell: x xᵀ/n
+ 2I, n = EST_N, PROBES right-hand sides, tol 1e-6, f32) with the shipped
K7 and each parent's swapped in, in turns (A B B A, twice): its wall
(host clock to ``torch.cuda.synchronize()``), its iterations (K7's
launches) and Σ K7 per call (iterations x K7's f32 time above).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))                   # chip_smoke's dense cell
sys.path.insert(0, str(Path(__file__).resolve().parent))

EST_N, PROBES, CG_TOL = 16384, 32, 1e-6
# (n, k, rows dropped from an (n + rows, n) matrix: 1 leaves its rows off
# a 16-byte boundary for odd n)
K7_CHECK = [(1, 1, 0), (37, 5, 0), (257, 33, 0), (1000, 32, 0),
            (300, 65, 0), (4097, 32, 0), (1025, 32, 1), (1025, 3, 1),
            (EST_N, PROBES, 0)]
# the C signature of the first K7, before it took the product's cut
PARENT_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 9 + (
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)
# name: substitutions in cg_step.cu
SOURCE_VARIANTS = {
    # the update pass one element a thread, never in 16-byte vectors
    "k7_update_scalar": {
        "const bool vec = g.k % Vec16<T>::n == 0 && any % 16 == 0;":
        "const bool vec = false && any % 16 == 0;"},
    # 32 rows a block in the update pass, not 128: four times the blocks,
    # each reducing the partial dots
    "k7_update_rows_32": {"constexpr long long kUpdateRows = 128;":
                          "constexpr long long kUpdateRows = 32;"},
}


def build(jobs: dict, nvcc: str, flags) -> dict:
    """nvcc for every ``cg_step.cu`` of ``jobs`` ({name: (csrc directory,
    argtypes)}) at once; ``{name: C entry}``."""
    from repro_torch.kernels import _build
    procs = {}
    for name, (src_dir, _) in jobs.items():
        d = ROOT / "build" / "k7_variants" / name
        d.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(src_dir), "-o", str(d / "cg_step.so"),
             str(src_dir / "cg_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        print(json.dumps({"variant": name, "source": "cg_step",
                          "ptxas": _build._ptxas_summary(log)}), flush=True)
        fn = ctypes.CDLL(str(ROOT / "build" / "k7_variants" / name /
                             "cg_step.so")).repro_cg_step
        fn.argtypes = jobs[name][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def substituted(csrc: Path, subs: dict, out: Path) -> Path:
    """A copy of ``csrc`` in ``out`` with ``subs`` applied (each must)."""
    out.mkdir(parents=True, exist_ok=True)
    found = set()
    for path in sorted(csrc.iterdir()):
        text = path.read_text()
        for old, new in subs.items():
            if old in text:
                found.add(old)
                text = text.replace(old, new)
        (out / path.name).write_text(text)
    missing = set(subs) - found
    if missing:
        raise SystemExit(f"substitution does not apply: {missing}")
    return out


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def k7_call(a, p, x, r, rz, cut=None, fn=None):
    """K7 through the C entry ``fn`` (None: the shipped one) with the cut
    ``cut`` (a `matvec.MatvecPlan`; None: `matvec.plan`'s for (n, n, k),
    as the wrapper takes it)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import matvec as k5
    n, k = p.shape
    c = cut or k5.plan(n, n, k, a.dtype, k5._sm_count(0))
    x_new, r_new, ap = (torch.empty_like(p) for _ in range(3))
    partials = torch.empty((-(-n // c.bm), k), dtype=a.dtype,
                           device=a.device)
    slices = (torch.empty(c.workspace, dtype=a.dtype, device=a.device)
              if c.workspace else None)
    rc = (fn or _build.function("cg_step"))(
        _build.dtype_code(a.dtype), a.data_ptr(), p.data_ptr(), x.data_ptr(),
        r.data_ptr(), rz.data_ptr(), x_new.data_ptr(), r_new.data_ptr(),
        ap.data_ptr(), partials.data_ptr(),
        None if slices is None else slices.data_ptr(), n, k, c.bm, c.bn,
        c.chunk, c.splits, c.split_len, _build.stream(a))
    _build.check(rc, "cg_step")
    return x_new, r_new


def parent_call(fn, a, p, x, r, rz):
    """An earlier tree's K7 through its own C signature."""
    import torch
    from repro_torch.kernels import _build
    n, k = p.shape
    x_new, r_new, ap = (torch.empty_like(p) for _ in range(3))
    partials = torch.empty((-(-n // 32), k), dtype=a.dtype, device=a.device)
    rc = fn(_build.dtype_code(a.dtype), a.data_ptr(), p.data_ptr(),
            x.data_ptr(), r.data_ptr(), rz.data_ptr(), x_new.data_ptr(),
            r_new.data_ptr(), ap.data_ptr(), partials.data_ptr(), n, k,
            _build.stream(a))
    _build.check(rc, "cg_step (parent)")
    return x_new, r_new


def split_cut(n, k, dtype, splits):
    """K7's cut (`matvec.plan` for (n, n, k)) with the reduction axis in
    ``splits`` equal ranges of whole stages (one range: not split); the
    warp-per-row path (k <= 4) is never split."""
    from repro_torch.kernels import matvec as k5
    p = k5.plan(n, n, k, dtype, k5._sm_count(0))
    if k <= k5.MAX_GEMV_COLS:
        return p
    align = max(k5.SPLIT_ALIGN, p.chunk)
    length = -(-(-(-n // align)) // splits) * align
    count = -(-n // length)
    return p._replace(splits=count, split_len=length,
                      workspace=count * n * k if count > 1 else 0)


def plain_epilogue(ap, p, x, r, rz):
    """The rest of `ref.cg_step_ref` on a given product ``ap``."""
    import torch
    den = (p * ap).sum(-2)
    big = den.abs() > torch.finfo(den.dtype).tiny
    safe = torch.where(big, den, torch.ones_like(den))
    alpha = torch.where(big, rz / safe, torch.zeros_like(rz))[None, :]
    return x + alpha * p, r - alpha * ap


def variants(source_fns: dict, parent_fns: dict) -> dict:
    from repro_torch.kernels import matvec as k5
    out = {
        "shipped": k7_call,
        # the reduction axis whole, in two ranges, in four
        **{f"k7_split_{s}": (lambda s: lambda a, p, *t: k7_call(
            a, p, *t, cut=split_cut(*p.shape, a.dtype, s)))(s)
           for s in (1, 2, 4)},
        # K5's product, then the epilogue by PyTorch's elementwise ops
        "k7_k5_then_plain": lambda a, p, x, r, rz: plain_epilogue(
            k5.matvec(a, p), p, x, r, rz),
    }
    for name, fn in source_fns.items():
        out[name] = (lambda fn: lambda *t: k7_call(*t, fn=fn))(fn)
    for name, fn in parent_fns.items():
        out[name] = (lambda fn: lambda *t: parent_call(fn, *t))(fn)
    return out


def operands(n, k, skip, dtype, gen):
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)
    a = randn(n + skip, n)[skip:]
    p, x, r, rz = randn(n, k), randn(n, k), randn(n, k), randn(k)
    p[:, 0] = 0                                  # a converged column
    return a, p, x, r, rz


def check(calls: dict, gen) -> None:
    import torch
    from repro_torch.kernels import ref
    for dtype in (torch.float32, torch.float64):
        for n, k, skip in K7_CHECK:
            args = operands(n, k, skip, dtype, gen)
            want = ref.cg_step_ref(*args)
            tol = ref.cg_step_bound(*args)
            x, r = args[2], args[3]
            for name, call in calls.items():
                got = call(*args)
                worst = max((((g - w).abs() / (2 * t).clamp_min(
                    torch.finfo(dtype).tiny)).max().item())
                    for g, w, t in zip(got, want, tol))
                if worst > 1.0:
                    raise SystemExit(f"K7 {name} {dtype} {(n, k, skip)}: at "
                                     f"{worst} of twice its bound")
                if not (torch.equal(got[0][:, 0], x[:, 0])
                        and torch.equal(got[1][:, 0], r[:, 0])):
                    raise SystemExit(f"K7 {name} {dtype} {(n, k, skip)}: "
                                     "a converged column moved")
            first, again = calls["shipped"](*args), calls["shipped"](*args)
            if not all(torch.equal(u, v) for u, v in zip(first, again)):
                raise SystemExit(f"K7 {dtype} {(n, k, skip)}: a repeated "
                                 "call differs")
            del args, want, tol, first, again
        print(json.dumps({"kernel": "cg_step", "dtype": str(dtype)[6:],
                          "checked": K7_CHECK,
                          "within_twice_bound": list(calls),
                          "converged_column_exact": True,
                          "shipped_repeat_bitwise": True}), flush=True)


def main() -> int:
    import torch
    from card_timing import queued_ms, sleep_ms
    from repro_torch.kernels import _build, fused_est, ref
    from repro_torch.kernels import matvec as k5

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    metavar="[NAME=]DIR",
                    help="csrc directory of an earlier tree: the variant "
                         "NAME (default 'parent'); may be repeated")
    args = ap.parse_args()
    parents = {}
    for spec in args.parent:
        name, _, path = spec.rpartition("=")
        parents[name or "parent"] = Path(path)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi(), flush=True)
    print(json.dumps({"build": _build.build()["kernels"]["cg_step"]}),
          flush=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {name: (substituted(csrc, subs, ROOT / "build" / "k7_variants" /
                               name / "csrc"), _build._ARGTYPES["cg_step"])
            for name, subs in SOURCE_VARIANTS.items()}
    jobs.update({name: (d, PARENT_ARGTYPES) for name, d in parents.items()})
    fns = build(jobs, _build._nvcc(), _build.NVCC_FLAGS)
    parent_fns = {name: fns[name] for name in parents}
    print(json.dumps({"sleep_ms": sleep_ms()}), flush=True)

    def time_ms(fn):
        return queued_ms(fn, iters=50)

    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = variants({name: fns[name] for name in SOURCE_VARIANTS},
                     parent_fns)
    check(calls, gen)

    n, k = EST_N, PROBES
    k7_ms = {}
    for dtype in (torch.float32, torch.float64):
        a, p, x, r, rz = t = operands(n, k, 0, dtype, gen)
        size = dtype.itemsize
        row = {"kernel": "cg_step", "dtype": str(dtype)[6:],
               "shape": [n, n, k],
               "cut": k5.plan(n, n, k, dtype, k5._sm_count(0))._asdict(),
               "bound_ms": (n * n + 5 * n * k + k) * size / 3.35e9}
        for name, call in calls.items():
            row[name] = time_ms(lambda: call(*t))
        row["shipped_again"] = time_ms(lambda: calls["shipped"](*t))
        row["matvec"] = time_ms(lambda: k5.matvec(a, p))
        row["matmul"] = time_ms(lambda: a @ p)
        row["plain"] = time_ms(lambda: ref.cg_step_ref(*t))
        print(json.dumps(row), flush=True)
        if dtype == torch.float32:
            k7_ms = row
        del a, p, x, r, rz, t
        torch.cuda.empty_cache()

    # the dense CG route with each tree's K7 swapped in, in turns (A B B
    # A, twice): wall, iterations (K7's launches), and Σ K7 per call
    from chip_smoke import dense_spd
    from repro_torch import estimators as est
    from repro_torch.kernels import ops
    cell = dense_spd(n, gen, torch.float32)
    b = torch.randn(n, k, generator=gen, device="cuda", dtype=torch.float32)
    shipped = fused_est.cg_step
    trees = {"shipped": shipped}
    for name, fn in parent_fns.items():
        def counted(*t, fn=fn):
            fused_est.cg_step_launches += 1
            return parent_call(fn, *t)
        trees[name] = counted
    walls = {name: [] for name in trees}
    iters = {name: [] for name in trees}
    try:
        for name, fn in trees.items():             # warm-up, not timed
            fused_est.cg_step = fn
            est.cg_solve(cell, b, tol=CG_TOL)
        for name in (list(trees) + list(trees)[::-1]) * 2:
            fused_est.cg_step = trees[name]
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = est.cg_solve(cell, b, tol=CG_TOL)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            launches = ops.launch_counts()["cg_step"]
            if launches != res.iters or not bool(res.converged):
                raise SystemExit(f"dense|cg {name}: {launches} K7 launches, "
                                 f"{res.iters} iterations, converged "
                                 f"{bool(res.converged)}")
            iters[name].append(res.iters)
    finally:
        fused_est.cg_step = shipped
    print(json.dumps({
        "route": "dense|cg", "n": n, "k": k, "wall_s": walls,
        "iterations": iters,
        "card_ms": {name: iters[name][0] * k7_ms[name] for name in trees}}),
        flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
