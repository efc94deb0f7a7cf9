"""Time K5's tile (``src/repro_torch/kernels/csrc/matvec.cu`` on
``skinny_mma.cuh``) against variants of its design, beside cuBLAS's
``a @ x``, on one NVIDIA card.

Each variant is the shipped source with one design choice undone by a
text substitution (each must apply), built by nvcc with the package's
flags into ``build/k5_variants/<name>/`` (all builds started together).
A variant is checked against the f64 product within ``ref.matvec_bound``
(twice it in f64) on a few shapes, then timed at the sharded
estimators' shapes, in turns with ``a @ x`` (library, variants...,
library).  Two diagnostics split the shipped kernel's time and are not
checked: ``stream_only`` copies A but does no arithmetic,
``compute_only`` does the arithmetic on whatever the ring holds.

    python3 tools/k5_variants.py

Prints the card's name and power limit, then one JSON line per check
and per timed shape (ms; ``bound_ms`` by bytes at 3.35 TB/s).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

NOBULK = {"  if (aligned && n % skinny::Layout<T, BN>::BK == 0 &&":
          "  if (false && n % skinny::Layout<T, BN>::BK == 0 &&"}
ONE_WARP = {"    if (tid < rows) bulk_copy(as + tid * L::LDA, a + (row0 + tid) * n + c0,"
            " kChunkBytes, bar);":
            "    if (tid < 32) for (int r = tid; r < rows; r += 32)"
            " bulk_copy(as + r * L::LDA, a + (row0 + r) * n + c0, kChunkBytes, bar);"}
TILE = "static constexpr int TM = BN == 64 ? 8 : 4;"
NO_ARITHMETIC = {"    tile.consume(as, as + L::A_ELEMS);": ""}
NO_COPIES = {"    if (ch + S - 1 < chunks) load(ch + S - 1);": "",
             "    if (s < chunks) load(s);": "",
             "      mbar_wait(bars + (int)(ch % S), (unsigned)(ch / S) & 1u);"
             "   // (the engine's)": "      (void)0;"}
# name: (source substitutions, `kernels.matvec` constants, checked)
VARIANTS = {
    "shipped": ({}, {}, True),
    "chunk_128B": ({"kChunkBytes = 256;": "kChunkBytes = 128;"},
                   {"CHUNK_BYTES": 128}, True),
    "cp_async_16B": (NOBULK, {}, True),
    "one_warp_issues_bulk": (ONE_WARP, {}, True),
    "f32_tile_8x8": ({TILE: "static constexpr int TM = 8;"}, {}, True),
    "f32_tile_4x8_at_64": ({TILE: "static constexpr int TM = 4;"}, {}, True),
    "f32_tile_2x8_to_32": ({TILE: "static constexpr int TM = BN == 64 ? 8 : 2;"},
                           {}, True),
    "one_block_per_sm_4_stages": (
        {"kBlocksPerSm = 2;": "kBlocksPerSm = 1;", "kStages = 2;": "kStages = 4;"},
        {"BLOCKS_PER_SM": 1}, True),
    "stream_only": (NO_ARITHMETIC, {}, False),
    "compute_only": (NO_COPIES, {}, False),
}
CHECK = [(129, 257, 33), (64, 128, 64), (100, 300, 65), (256, 16384, 32),
         (129, 1001, 32), (300, 2048, 8), (200, 1024, 32)]
TIME = [(16384, 16384, 16), (16384, 16384, 32), (16384, 16384, 64),
        (4096, 16384, 32), (4096, 16384, 64)]


def sources(name: str, csrc: Path) -> dict:
    """The variant's edited sources, by file name."""
    subs = VARIANTS[name][0]
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


def main() -> int:
    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import matvec as k5

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_root = ROOT / "build" / "k5_variants"
    procs = {}
    for name in VARIANTS:
        d = out_root / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in sources(name, _build.CSRC).items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d.parent / "libmatvec.so"), str(d / "matvec.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        summary = _build._ptxas_summary(log)
        print(json.dumps({"variant": name, "ptxas": summary}), flush=True)
        fn = ctypes.CDLL(str(out_root / name / "libmatvec.so")).repro_matvec
        fn.argtypes, fn.restype = _build._ARGTYPES["matvec"], ctypes.c_int
        fns[name] = fn
    _build.build()
    defaults = {a: getattr(k5, a) for v in VARIANTS.values() for a in v[1]}

    def use(name):
        _build._functions["matvec"] = fns[name]
        for attr, value in defaults.items():
            setattr(k5, attr, VARIANTS[name][1].get(attr, value))

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

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)

    dtypes = (torch.float32, torch.float64)
    for name in VARIANTS:
        if not VARIANTS[name][2]:
            continue
        use(name)
        for dt in dtypes:
            worst = 0.0
            for m, n, k in CHECK:
                a, x = randn(m, n, dtype=dt), randn(n, k, dtype=dt)
                got = k5.matvec(a, x)
                exact = a.double() @ x.double()
                bound = (2.0 if dt == torch.float64 else 1.0) * \
                    ref.matvec_bound(a, x).double()
                worst = max(worst, ((got.double() - exact).abs()
                                    / bound.clamp_min(1e-300)).max().item())
                if not torch.equal(k5.matvec(a, x), got):
                    raise SystemExit(f"{name} {dt} {(m, n, k)}: repeat differs")
            print(json.dumps({"variant": name, "dtype": str(dt)[6:],
                              "max_rel_to_bound": worst}), flush=True)
            if worst > 1.0:
                raise SystemExit(f"{name} {dt}: outside the bound")
    for dt in dtypes:
        full = randn(16384, 16384, dtype=dt)
        size = torch.finfo(dt).bits // 8
        for m, n, k in TIME:
            a, x = full[:m], randn(n, k, dtype=dt)
            row = {"dtype": str(dt)[6:], "shape": [m, n, k],
                   "bound_ms": (m * n + n * k + m * k) * size / 3.35e9}
            lib = time_ms(lambda: a @ x)
            for name in VARIANTS:
                use(name)
                row[name] = time_ms(lambda: k5.matvec(a, x))
            use("shipped")
            row["library"] = (lib + time_ms(lambda: a @ x)) / 2
            print(json.dumps(row), flush=True)
        del full
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
