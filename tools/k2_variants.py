"""Time K2 (``src/repro_torch/kernels/csrc/panel_update.cu``) against
variants of its design, beside ``torch.addmm(a, c, r, alpha=-1)`` and the
byte bound, on one NVIDIA card.

A variant is the shipped source with one design choice changed by a text
substitution (each must apply), built by nvcc with the package's flags
into ``build/k2_variants/<name>/`` (all builds started together).  Each
``--parent [NAME=]DIR`` adds the variant NAME (default ``parent``):
``DIR/panel_update.cu`` built against the headers beside it.  Point it at
the ``csrc`` directory of an earlier tree of the port (``git archive
<commit> | tar -x -C build/parent`` unpacks one where nothing is
committed).  Every variant keeps K2's summation order (one FMA chain over
k in order, then one subtract), so each must equal the shipped kernel bit
for bit on a few shapes before it is timed; the shipped kernel must also
lie within the summation-order bound of the plain version
(``ref.panel_update_bound``).

    python3 tools/k2_variants.py [--parent [NAME=]DIR ...]

Prints the card's name and power limit, then one JSON line per build
(ptxas: registers, shared memory, spills), per check and per timed
shape: ms per launch on the card, 50 launches queued behind a sleeping
kernel so that the host's enqueue time is hidden (``card_timing.py``;
for the shipped kernel and each ``--parent`` also that enqueue time per
call, ``<name>_enqueue_us``, wrapper included);
``bound_ms`` by bytes at 3.35 TB/s (each input read once, the output
written once).  Beside them: the one PyTorch call computing the same
function (``addmm``: ``torch.addmm(a, c, r, alpha=-1)``, with
``out_dtype=a.dtype`` for bf16 operands; where the card refuses it, the
error instead, and whether its result lies within the same bound), and
two pure streams of the buffer: ``copy`` (``o.copy_(a)``: the bytes of
``a`` and ``out``, as K2 moves them) and ``sub`` (``torch.sub(a, b,
out=o)``: one more matrix read).
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

# each Config line of the shipped source: (accumulator, operand) type ->
# (TM, J, S, PERSIST)
F32, BF16, F64 = ("float", "float"), ("float", "__nv_bfloat16"), ("double", "double")
SHIPPED = {F32: (4, 2, 2, 1), BF16: (8, 2, 2, 1), F64: (4, 2, 1, 0)}


def config_line(types, cfg) -> str:
    tm, j, s, persist = cfg
    return (f"template <> struct Config<{types[0]}, {types[1]}> {{ static "
            f"constexpr int TM = {tm}, J = {j}, S = {s}, PERSIST = {persist}; }};")


def config(types, cfg) -> dict:
    """The substitution setting (TM, J, S, PERSIST) of one type pair."""
    return {config_line(types, SHIPPED[types]): config_line(types, cfg)}


# name: source substitutions
VARIANTS = {
    "shipped": {},
    "f32_one_tile_per_block": config(F32, (4, 2, 1, 0)),
    "f32_stages_1": config(F32, (4, 2, 1, 1)),
    "f32_stages_3": config(F32, (4, 2, 3, 1)),
    "f32_rows_32": config(F32, (2, 2, 2, 1)),
    "f32_rows_128": config(F32, (8, 2, 2, 1)),
    "f32_cols_64": config(F32, (4, 1, 2, 1)),
    "bf16_rows_64": config(BF16, (4, 2, 2, 1)),
    "bf16_rows_64_one_tile": config(BF16, (4, 2, 1, 0)),
    "bf16_rows_128_one_tile": config(BF16, (8, 2, 1, 0)),
    "f64_persistent": config(F64, (4, 2, 2, 1)),
    "f64_persistent_stages_1": config(F64, (4, 2, 1, 1)),
    "f64_stages_2": config(F64, (4, 2, 2, 0)),
    "f64_rows_32": config(F64, (2, 2, 1, 0)),
    "f64_cols_32": config(F64, (4, 1, 1, 0)),
    # c and r fetched into registers early (as bf16 operands are), not by
    # cp.async
    "cr_through_registers": {"      if constexpr (kSameType) {":
                             "      if constexpr (false) {",
                             "    if constexpr (!kSameType && S > 1)":
                             "    if constexpr (S > 1)"},
    # bf16 operands widened into the stage as soon as they are loaded,
    # before the current tile's work (the warp waits for the loads)
    "bf16_widened_at_once": {
        "    fill(t + (S - 1) * stride, s_next, S == 1);":
        "    fill(t + (S - 1) * stride, s_next, true);",
        "    if constexpr (!kSameType && S > 1)": "    if constexpr (false)"},
    # whether a and out take 16-byte copies decided in the kernel at run
    # time (as for c and r), one instantiation, in place of the VEC
    # template parameter
    "vec_at_run_time": {
        "  const bool r_vec = n % W == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;\n":
        "  const bool r_vec = n % W == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;\n"
        "  const bool a_vec = n % W == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&\n"
        "                     reinterpret_cast<uintptr_t>(out) % 16 == 0;\n",
        "      copy_async<T, L::BM, L::BN>(st, tl.a, m, n, n, row0, col0, VEC);":
        "      copy_async<T, L::BM, L::BN>(st, tl.a, m, n, n, row0, col0, a_vec);",
        "        if constexpr (VEC) {\n          if (gj < n) {":
        "        if (a_vec) {\n          if (gj < n) {",
        "  return vec ? launch_kernel<T, OpT, true, false>(a, c, r, out, batch, m, n, k, stream)\n"
        "             : launch_kernel<T, OpT, false, false>(a, c, r, out, batch, m, n, k, stream);":
        "  return launch_kernel<T, OpT, false, false>(a, c, r, out, batch, m, n, k, stream);"},
    # a's tile into its stage by the copy engine: one `cp.async.bulk` a row
    # (BM rows of BN elements), counted on the stage's mbarrier,
    # in place of 16-byte cp.async copies by every thread
    "a_bulk_copy": {
        "  static constexpr int SMEM_BYTES = S * STAGE_ELEMS * (int)sizeof(T);":
        "  static constexpr int SMEM_BYTES = S * STAGE_ELEMS * (int)sizeof(T)"
        " + 8 * S;",
        "  const long long stride = gridDim.x;\n":
        "  const long long stride = gridDim.x;\n"
        "  uint64_t* bars = reinterpret_cast<uint64_t*>(\n"
        "      smem_raw + S * L::STAGE_ELEMS * sizeof(T));\n"
        "  if (VEC && threadIdx.x == 0) {\n"
        "    for (int s = 0; s < S; ++s) repro::skinny::mbar_init(bars + s);\n"
        "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: "
        "\"memory\");\n"
        "  }\n"
        "  __syncthreads();\n",
        "      copy_async<T, L::BM, L::BN>(st, tl.a, m, n, n, row0, col0, VEC);":
        "      if constexpr (VEC) {\n"
        "        const int rows = m - row0 < L::BM ? (int)(m - row0) : L::BM;\n"
        "        const unsigned bytes = (unsigned)((n - col0 < L::BN ? "
        "n - col0 : L::BN) * sizeof(T));\n"
        "        if (threadIdx.x == 0) repro::skinny::mbar_expect(bars + s, "
        "rows * bytes);\n"
        "        if (threadIdx.x < rows) {\n"
        "          asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
        "\"memory\");\n"
        "          repro::skinny::bulk_copy(st + threadIdx.x * L::BN, "
        "tl.a + (row0 + threadIdx.x) * n + col0, bytes, bars + s);\n"
        "        }\n"
        "      } else {\n"
        "        copy_async<T, L::BM, L::BN>(st, tl.a, m, n, n, row0, col0, "
        "VEC);\n"
        "      }",
        "    cp_async_wait<S - 1>();   // this thread's copies of stage s "
        "have landed":
        "    cp_async_wait<S - 1>();\n"
        "    if (VEC) repro::skinny::mbar_wait(bars + s, (unsigned)(j / S) & 1u);"},
}
CHECK = [(33, 129, 7), (257, 383, 32), (100, 300, 48), (2048, 2048, 32),
         (32, 8192, 32)]
TIME = [(8192, 8192, 32), (4608, 4608, 32), (32, 8192, 32), (64, 64, 32)]
TYPES = [("float32", "float32"), ("float64", "float64"),
         ("float32", "bfloat16"), ("float64", "bfloat16")]


def sources(name: str, csrc: Path) -> dict:
    """The variant's edited sources, by file name."""
    subs = VARIANTS[name]
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
        raise SystemExit(f"{name}: substitution does not apply: {missing}")
    return out


def build(names, parents, nvcc, flags) -> dict:
    """nvcc for every variant at once; returns ``{name: C entry}``."""
    out_root = ROOT / "build" / "k2_variants"
    procs = {}
    for name in names:
        d = out_root / name
        if name in parents:
            src_dir = parents[name]
        else:
            src_dir = d / "csrc"
            src_dir.mkdir(parents=True, exist_ok=True)
            for fname, text in sources(name, ROOT / "src" / "repro_torch"
                                       / "kernels" / "csrc").items():
                (src_dir / fname).write_text(text)
        d.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-I", str(src_dir), "-o", str(d / "libk2.so"),
             str(src_dir / "panel_update.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        from repro_torch.kernels import _build
        print(json.dumps({"variant": name,
                          "ptxas": _build._ptxas_summary(log)}), flush=True)
        fn = ctypes.CDLL(str(out_root / name / "libk2.so")).repro_panel_update
        fn.argtypes = _build._ARGTYPES["panel_update"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    from card_timing import queued_ms, queued_times, sleep_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import panel_update as k2

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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    names = list(VARIANTS) + list(parents)
    fns = build(names, parents, _build._nvcc(), _build.NVCC_FLAGS)
    _build.build()

    def use(name):
        _build._functions["panel_update"] = fns[name]

    def time_ms(fn):
        return queued_ms(fn, iters=50)

    print(json.dumps({"sleep_ms": sleep_ms()}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def operands(m, n, k, dt, op):
        dt, op = getattr(torch, dt), getattr(torch, op)

        def randn(*shape, dtype):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float64).to(dtype)
        return (randn(m, n, dtype=dt), randn(m, k, dtype=op),
                randn(k, n, dtype=op))

    for dt, op in TYPES:
        for m, n, k in CHECK:
            a, c, r = operands(m, n, k, dt, op)
            use("shipped")
            want = k2.panel_update(a, c, r)
            plain = ref.panel_update_ref(a, c, r)
            tol = ref.panel_update_bound(a, c, r, plain)
            if not bool(((want - plain).abs() <= tol).all()):
                raise SystemExit(f"shipped {dt}/{op} {(m, n, k)}: outside "
                                 "the summation-order bound")
            for name in names:
                use(name)
                if not torch.equal(k2.panel_update(a, c, r), want):
                    raise SystemExit(f"{name} {dt}/{op} {(m, n, k)}: "
                                     "differs from the shipped kernel")
        print(json.dumps({"types": f"{dt}/{op}", "checked": CHECK,
                          "bitwise_with_shipped": names}), flush=True)

    def library(a, c, r):
        """torch.addmm for a - c @ r, with out_dtype for bf16 operands."""
        if a.dtype == c.dtype:
            return torch.addmm(a, c, r, alpha=-1)
        return torch.addmm(a, c, r, out_dtype=a.dtype, alpha=-1)

    for dt, op in TYPES:
        for m, n, k in TIME:
            a, c, r = operands(m, n, k, dt, op)
            size, op_size = a.element_size(), c.element_size()
            row = {"types": f"{dt}/{op}", "shape": [m, n, k],
                   "bound_ms": (2 * m * n * size + (m + n) * k * op_size)
                   / 3.35e9}
            try:
                lib = library(a, c, r)
                plain = ref.panel_update_ref(a, c, r)
                row["addmm_within_bound"] = bool(
                    ((lib - plain).abs()
                     <= ref.panel_update_bound(a, c, r, plain)).all())
                del lib, plain
                lib_ms = time_ms(lambda: library(a, c, r))
            except RuntimeError as e:
                row["addmm_error"] = str(e).splitlines()[0]
                lib_ms = None
            for name in names:
                use(name)
                if name == "shipped" or name in parents:
                    # and the host's time to enqueue one call
                    row[name], host = queued_times(
                        lambda: k2.panel_update(a, c, r), iters=50)
                    row[f"{name}_enqueue_us"] = host * 1e3
                else:
                    row[name] = time_ms(lambda: k2.panel_update(a, c, r))
            use("shipped")
            row["shipped_again"] = time_ms(lambda: k2.panel_update(a, c, r))
            if lib_ms is not None:
                row["addmm"] = (lib_ms + time_ms(lambda: library(a, c, r))) / 2
            b, o = torch.empty_like(a), torch.empty_like(a)
            row["copy"] = time_ms(lambda: o.copy_(a))
            row["sub"] = time_ms(lambda: torch.sub(a, b, out=o))
            print(json.dumps(row), flush=True)
            del a, c, r, b, o
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
