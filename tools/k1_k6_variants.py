"""Time K1 (``csrc/condense_step.cu``) and K6 (``csrc/cheb_step.cu``)
against variants of their designs and an earlier tree's kernels, and sum
each over the route that launches it, on one NVIDIA card.

A K1 variant is the shipped source with one design choice changed by a
text substitution (each must apply), built by nvcc with the package's
flags into ``build/k1_k6_variants/<name>/`` (all builds started
together).  A K6 variant is the shipped kernel launched with another cut
than ``matvec.plan`` gives (the C entry takes any consistent cut), or
K5 followed by the plain epilogue.  Each ``--parent [NAME=]DIR`` adds the
kernels ``DIR/condense_step.cu`` and ``DIR/cheb_step.cu`` of an earlier
tree, built against the headers beside them: point it at the ``csrc``
directory of that tree (``git archive <commit> | tar -x -C build/parent``
unpacks one where nothing is committed).

Checks before any timing: every K1 variant and parent bitwise equal to
``ref.rank1_update_ref`` (signed zeros, infinities and NaNs included) in
every dtype pair; every K6 variant and parent within twice
``ref.cheb_step_bound`` of the plain version, and a repeated call of the
shipped K6 bitwise equal.

    python3 tools/k1_k6_variants.py [--parent [NAME=]DIR ...] [--kernels k1 k6]

Prints the card's name and power limit, then one JSON line per build
(ptxas: registers, shared memory, spills), per check and per timed shape:
ms per launch on the card, 50 launches queued behind a sleeping kernel
so that the host's enqueue time is hidden (``card_timing.py``).  Beside
K1: ``torch.addr(a, pc, pr, alpha=-1)``, the one PyTorch call computing
the same function, and ``copy`` (``o.copy_(a)``, a pure stream of the
bytes K1 moves).  Beside K6: K5 (``matvec.matvec(a, w)``, the product
alone on the tile K6 shares) and cuBLAS's ``a @ w``.  ``bound_ms`` by
bytes at 3.35 TB/s.  Then the route sums: K1 over the staged x rank1
route's 8191 calls at N = 8192 (its stages' widths, f32), and K6 over the
dense x chebyshev route's 63 calls (degree 64) at n = 16384, k = 32; and
the staged x rank1 route end to end on ``chip_smoke.py``'s exact cell
with the shipped K1 and each parent's swapped in, in turns: its wall
(host clock to ``torch.cuda.synchronize()``) and the host's time to
enqueue one full-width K1 call.
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
sys.path.insert(0, str(Path(__file__).resolve().parent))

K1_SOURCE, K6_SOURCE = "condense_step", "cheb_step"
# name: substitutions in condense_step.cu
K1_VARIANTS = {
    "shipped": {},
    # four rows' loads in flight per thread, not eight
    "k1_rows_4": {"constexpr int kRows = 8;": "constexpr int kRows = 4;"},
    # persistent blocks: at most as many as the card holds at once (the
    # occupancy query), each walking the same number of row groups in a
    # grid-stride loop
    "k1_persistent": {
        "  const long long groups = (m + R - 1) / R;\n":
        "  const long long groups = (m + R - 1) / R;\n"
        "  long long grid_y = groups;\n"
        "  {\n"
        "    int dev = 0, per_sm = 0, sms = 0;\n"
        "    cudaGetDevice(&dev);\n"
        "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, "
        "kThreads, 0);\n"
        "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
        "dev);\n"
        "    long long most = (long long)per_sm * sms / col_blocks;\n"
        "    if (most < 1) most = 1;\n"
        "    if (groups > most) {\n"
        "      const long long rounds = (groups + most - 1) / most;\n"
        "      grid_y = (groups + rounds - 1) / rounds;\n"
        "    }\n"
        "  }\n",
        "  const long long i0 = (long long)blockIdx.y * R;\n"
        "  const int rows = (int)(m - i0 < R ? m - i0 : R);\n":
        "  for (long long i0 = (long long)blockIdx.y * R; i0 < m;"
        " i0 += (long long)gridDim.y * R) {\n"
        "  const int rows = (int)(m - i0 < R ? m - i0 : R);\n",
        "                  repro::sub_rn(x[r][v], repro::product<T>(c[r], "
        "prv[v]));\n        }\n    }\n  }\n}\n":
        "                  repro::sub_rn(x[r][v], repro::product<T>(c[r], "
        "prv[v]));\n        }\n    }\n  }\n  }\n}\n",
        "(unsigned)groups, (unsigned)mats)": "(unsigned)grid_y, (unsigned)mats)"},
    # calls of fewer than eight rows through the eight-row instance too
    "k1_no_one_row_instance": {"  return m < kRows\n":
                               "  return false\n"},
}
K1_CHECK = [(1, 1), (7, 129), (129, 7), (255, 383), (33, 257), (1, 8192),
            (100, 1023), (100, 1025), (3000, 2048)]
K1_TYPES = [("float32", "float32"), ("float64", "float64"),
            ("float32", "bfloat16"), ("float64", "bfloat16")]
K1_N = 8192
EST_N, PROBES, DEGREE = 16384, 32, 64
K6_CHECK = [(1, 1), (37, 5), (257, 33), (1000, 32), (300, 65), (4097, 32)]


def substituted(csrc: Path, subs: dict) -> dict:
    """The sources of ``csrc`` with ``subs`` applied, by file name."""
    out, found = {}, set()
    for path in sorted(csrc.iterdir()):
        text = path.read_text()
        for old, new in subs.items():
            if old in text:
                found.add(old)
                text = text.replace(old, new)
        out[path.name] = text
    missing = set(subs) - found
    if missing:
        raise SystemExit(f"substitution does not apply: {missing}")
    return out


# the C signature of the first K6, before it took the product's cut
PARENT_K6_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 9 + (
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)


def build(jobs, nvcc, flags, parents=()) -> dict:
    """nvcc for every (name, source) in ``jobs`` ({(name, source): csrc
    directory}) at once; returns ``{(name, source): C entry}`` (the K6 of
    a name in ``parents`` bound with its earlier signature)."""
    from repro_torch.kernels import _build
    out_root = ROOT / "build" / "k1_k6_variants"
    procs = {}
    for (name, source), src_dir in jobs.items():
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        procs[name, source] = subprocess.Popen(
            [nvcc, *flags, "-I", str(src_dir), "-o", str(d / f"{source}.so"),
             str(src_dir / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (name, source), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}/{source}: nvcc failed:\n{log}")
        print(json.dumps({"variant": name, "source": source,
                          "ptxas": _build._ptxas_summary(log)}), flush=True)
        entry = {K1_SOURCE: "rank1_update", K6_SOURCE: "cheb_step"}[source]
        fn = getattr(ctypes.CDLL(str(out_root / name / f"{source}.so")),
                     f"repro_{entry}")
        fn.argtypes = (PARENT_K6_ARGTYPES if name in parents
                       and source == K6_SOURCE else _build._ARGTYPES[entry])
        fn.restype = ctypes.c_int
        fns[name, source] = fn
    return fns


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def same_bits(a, b) -> bool:
    """Equal bit for bit (-0 differs from +0), NaNs by position only."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints))


def k1_special(a, pc, pr):
    """-0, +-inf and NaN planted in a, pc and pr (and products that give
    -0 and inf - inf)."""
    a[0, :3] = -0.0
    a[1, 1], a[1, 2], a[2, 0] = float("inf"), float("-inf"), float("nan")
    pc[0], pc[2] = -0.0, float("inf")
    pr[0], pr[1], pr[2] = 0.0, float("-inf"), float("nan")


def k1_section(names, fns, time_ms, gen) -> None:
    import torch
    from repro_torch.core.engine import stage_schedule
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import condense_step as k1

    def use(name):
        _build._functions["rank1_update"] = fns[name, K1_SOURCE]

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)

    for dt, op in K1_TYPES:
        dt_, op_ = getattr(torch, dt), getattr(torch, op)
        for m, n in K1_CHECK:
            for special in (False, True):
                if special and min(m, n) < 3:
                    continue
                a, pc, pr = randn(m, n, dtype=dt_), randn(m, dtype=op_), \
                    randn(n, dtype=op_)
                if special:
                    k1_special(a, pc, pr)
                want = ref.rank1_update_ref(a, pc, pr)
                views = [(a, pc, pr)]
                if m > 1:    # rows 1.. of a: not 16-byte aligned when n is odd
                    views.append((a[1:], pc[1:].contiguous(), pr))
                for name in names:
                    use(name)
                    for av, pcv, prv in views:
                        got = k1.rank1_update(av, pcv, prv)
                        if not same_bits(got, want[-av.shape[0]:]):
                            raise SystemExit(f"K1 {name} {dt}/{op} {(m, n)} "
                                             f"special={special}: not "
                                             "bitwise")
        print(json.dumps({"kernel": "rank1_update", "types": f"{dt}/{op}",
                          "checked": K1_CHECK, "bitwise": names}),
              flush=True)

    n = K1_N
    for dt in ("float32", "float64"):
        dt_ = getattr(torch, dt)
        size = dt_.itemsize
        a, pc, pr = randn(n, n, dtype=dt_), randn(n, dtype=dt_), \
            randn(n, dtype=dt_)
        o = torch.empty_like(a)
        row = {"kernel": "rank1_update", "dtype": dt, "shape": [n, n],
               "bound_ms": (2 * n * n + 2 * n) * size / 3.35e9}
        for name in names:
            use(name)
            row[name] = time_ms(lambda: k1.rank1_update(a, pc, pr))
        use("shipped")
        row["shipped_again"] = time_ms(lambda: k1.rank1_update(a, pc, pr))
        row["addr"] = time_ms(lambda: torch.addr(a, pc, pr, alpha=-1))
        row["copy"] = time_ms(lambda: o.copy_(a))
        print(json.dumps(row), flush=True)
        one = a[:1]
        row = {"kernel": "rank1_update", "dtype": dt, "shape": [1, n],
               "bound_ms": (2 * n + 1 + n) * size / 3.35e9}
        for name in names:
            use(name)
            row[name] = time_ms(lambda: k1.rank1_update(one, pc[:1], pr))
        row["addr"] = time_ms(lambda: torch.addr(one, pc[:1], pr, alpha=-1))
        print(json.dumps(row), flush=True)
        del a, o, one
        torch.cuda.empty_cache()

    # the staged x rank1 route at N = 8192, f32: K1 on every (size, size)
    # stage buffer, once per step
    route = {name: 0.0 for name in names}
    sched = stage_schedule(K1_N, 0.75, 64)
    calls = 0
    for size, steps in sched:
        a, pc, pr = randn(size, size, dtype=torch.float32), \
            randn(size, dtype=torch.float32), randn(size, dtype=torch.float32)
        row = {"kernel": "rank1_update", "dtype": "float32",
               "shape": [size, size], "staged_launches": steps}
        for name in names:
            use(name)
            row[name] = time_ms(lambda: k1.rank1_update(a, pc, pr))
            route[name] += steps * row[name]
        calls += steps
        print(json.dumps(row), flush=True)
    print(json.dumps({"route": "staged|rank1", "kernel": "rank1_update",
                      "n": K1_N, "launches": calls,
                      "card_ms": route}), flush=True)
    del a, pc, pr

    # the route end to end with each tree's K1 swapped in, in turns (A B B
    # A, twice), on chip_smoke.py's exact cell: its wall, and the host's
    # enqueue time per K1 call at full width
    import repro_torch
    from card_timing import queued_times
    trees = [name for name in names if name == "shipped"
             or not name.startswith("k1_")]
    x = randn(K1_N, K1_N, dtype=torch.float64)
    cell = x @ x.T / K1_N
    cell.diagonal().add_(2.0)
    cell[3] = -cell[3]
    cell = cell.to(torch.float32)
    del x
    pc, pr = cell[:, 0].contiguous(), cell[0].contiguous()
    walls = {name: [] for name in trees}
    enqueue = {}
    for name in (trees + trees[::-1]) * 2:
        use(name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = repro_torch.plan(cell, method="exact")()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        if name not in enqueue:
            enqueue[name] = queued_times(
                lambda: k1.rank1_update(cell, pc, pr), iters=50)[1] * 1e3
    print(json.dumps({"route": "staged|rank1", "n": K1_N,
                      "sign": res.sign.item(),
                      "logabsdet": res.logabsdet.item(), "wall_s": walls,
                      "k1_enqueue_us": enqueue}), flush=True)
    use("shipped")


def k6_call(fn, a, w, wp, v, c, wd, cut=None, parent=False):
    """K6 through the C entry ``fn``, with the cut ``cut`` (a
    `matvec.MatvecPlan`; None: `matvec.plan`'s for (n, n, k), as the
    wrapper takes it) or, for an earlier tree's kernel, its own signature
    (partials of one row per 32 rows)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import matvec as k5
    n, k = w.shape
    wn = torch.empty_like(w)
    dots = torch.empty(k, dtype=a.dtype, device=a.device)
    code, s = _build.dtype_code(a.dtype), _build.stream(a)
    if parent:
        partials = torch.empty((-(-n // 32), k), dtype=a.dtype,
                               device=a.device)
        rc = fn(code, a.data_ptr(), w.data_ptr(), wp.data_ptr(),
                v.data_ptr(), c.data_ptr(), wd.data_ptr(), wn.data_ptr(),
                dots.data_ptr(), partials.data_ptr(), n, k, s)
    else:
        p = cut or k5.plan(n, n, k, a.dtype, k5._sm_count(0))
        partials = torch.empty((-(-n // p.bm), k), dtype=a.dtype,
                               device=a.device)
        slices = (torch.empty(p.workspace, dtype=a.dtype, device=a.device)
                  if p.workspace else None)
        rc = fn(code, a.data_ptr(), w.data_ptr(), wp.data_ptr(),
                v.data_ptr(), c.data_ptr(), wd.data_ptr(), wn.data_ptr(),
                dots.data_ptr(), partials.data_ptr(),
                None if slices is None else slices.data_ptr(), n, k, p.bm,
                p.bn, p.chunk, p.splits, p.split_len, s)
    _build.check(rc, "cheb_step")
    return wn, dots


def split_cut(n, k, dtype, splits):
    """K6's cut (`matvec.plan` for (n, n, k)) with the reduction axis in
    ``splits`` equal ranges of whole stages (one range: not split)."""
    from repro_torch.kernels import matvec as k5
    p = k5.plan(n, n, k, dtype, k5._sm_count(0))
    align = max(k5.SPLIT_ALIGN, p.chunk)
    length = -(-(-(-n // align)) // splits) * align
    count = -(-n // length)
    return p._replace(splits=count, split_len=length,
                      workspace=count * n * k if count > 1 else 0)


def plain_epilogue(prod, w, wp, v, c, wd):
    """The recurrence of `ref.cheb_step_ref` on a given product."""
    wn = 2.0 * ((2.0 * prod - c * w) / wd) - wp
    return wn, (v * wn).sum(0)


def k6_section(parents, fns, time_ms, gen) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import matvec as k5

    shipped = fns["shipped", K6_SOURCE]
    variants = {
        "shipped": lambda *t: k6_call(shipped, *t),
        # the reduction axis whole, and in four ranges
        "k6_no_split": lambda *t: k6_call(
            shipped, *t, cut=split_cut(*t[1].shape, t[0].dtype, 1)),
        "k6_split_4": lambda *t: k6_call(
            shipped, *t, cut=split_cut(*t[1].shape, t[0].dtype, 4)),
        # K5's product, then the recurrence by PyTorch's elementwise ops
        "k6_k5_then_plain": lambda a, w, wp, v, c, wd: plain_epilogue(
            k5.matvec(a, w), w, wp, v, c, wd),
    }
    for name in parents:
        variants[name] = (lambda fn: lambda *t: k6_call(fn, *t, parent=True))(
            fns[name, K6_SOURCE])

    def operands(n, k, dtype):
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float64).to(dtype)
        return (randn(n, n), randn(n, k), randn(n, k), randn(n, k),
                torch.tensor([1.7], dtype=dtype, device="cuda"),
                torch.tensor([3.1], dtype=dtype, device="cuda"))

    for dtype in (torch.float32, torch.float64):
        for n, k in K6_CHECK + [(EST_N, PROBES)]:
            args = operands(n, k, dtype)
            want = ref.cheb_step_ref(*args)
            tol = ref.cheb_step_bound(*args)
            for name, call in variants.items():
                got = call(*args)
                worst = max((((g - w_).abs() / (2 * t).clamp_min(
                    torch.finfo(dtype).tiny)).max().item())
                    for g, w_, t in zip(got, want, tol))
                if worst > 1.0:
                    raise SystemExit(f"K6 {name} {dtype} {(n, k)}: at "
                                     f"{worst} of twice its bound")
            again = variants["shipped"](*args)
            first = variants["shipped"](*args)
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise SystemExit(f"K6 {dtype} {(n, k)}: a repeated call "
                                 "differs")
            del args, want, tol
        print(json.dumps({"kernel": "cheb_step", "dtype": str(dtype)[6:],
                          "checked": K6_CHECK + [(EST_N, PROBES)],
                          "within_twice_bound": list(variants),
                          "shipped_repeat_bitwise": True}), flush=True)

    n, k = EST_N, PROBES
    route = {}
    for dtype in (torch.float32, torch.float64):
        args = operands(n, k, dtype)
        a, w = args[0], args[1]
        size = dtype.itemsize
        row = {"kernel": "cheb_step", "dtype": str(dtype)[6:],
               "shape": [n, n, k],
               "cut": k5.plan(n, n, k, dtype, k5._sm_count(0))._asdict(),
               "bound_ms": (n * n + 4 * n * k + k) * size / 3.35e9}
        for name, call in variants.items():
            row[name] = time_ms(lambda: call(*args))
        row["shipped_again"] = time_ms(lambda: variants["shipped"](*args))
        row["matvec"] = time_ms(lambda: k5.matvec(a, w))
        row["matmul"] = time_ms(lambda: a @ w)
        print(json.dumps(row), flush=True)
        if dtype == torch.float32:
            route = {name: (DEGREE - 1) * row[name]
                     for name in ["shipped"] + list(parents)}
        del args, a, w
        torch.cuda.empty_cache()
    print(json.dumps({"route": "dense|chebyshev", "kernel": "cheb_step",
                      "n": n, "k": k, "launches": DEGREE - 1,
                      "card_ms": route}), flush=True)


def main() -> int:
    import torch
    from card_timing import queued_ms, sleep_ms
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    metavar="[NAME=]DIR",
                    help="csrc directory of an earlier tree: the variant "
                         "NAME (default 'parent'); may be repeated")
    ap.add_argument("--kernels", nargs="+", default=["k1", "k6"],
                    choices=["k1", "k6"])
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

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    jobs = {}
    for name, subs in K1_VARIANTS.items():
        d = ROOT / "build" / "k1_k6_variants" / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in substituted(csrc, subs).items():
            (d / fname).write_text(text)
        jobs[name, K1_SOURCE] = d
    jobs["shipped", K6_SOURCE] = jobs["shipped", K1_SOURCE]
    for name, d in parents.items():
        jobs[name, K1_SOURCE] = jobs[name, K6_SOURCE] = d
    fns = build(jobs, _build._nvcc(), _build.NVCC_FLAGS, parents)
    _build.build()
    print(json.dumps({"sleep_ms": sleep_ms()}), flush=True)

    def time_ms(fn):
        return queued_ms(fn, iters=50)

    gen = torch.Generator(device="cuda").manual_seed(0)
    if "k1" in args.kernels:
        k1_section(list(K1_VARIANTS) + list(parents), fns, time_ms, gen)
    if "k6" in args.kernels:
        k6_section(list(parents), fns, time_ms, gen)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
