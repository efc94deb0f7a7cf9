"""Time K4 (``src/repro_torch/kernels/csrc/panel_factor.cu``, one
thread-block cluster per panel) against variants of its design, beside
``torch.linalg.lu_factor_ex`` of the transposed panel, on one NVIDIA card.

A source variant is the shipped source with one design choice undone by
a text substitution (each must apply; ``persistent_grid_*`` replace the
cluster by a grid of ordinary blocks that exchange through global
memory), built by nvcc with the package's
flags into ``build/k4_variants/<name>/`` (all builds started together); a
plan variant runs the shipped build under other `kernels.panel_factor`
constants.  A checked variant must match the plain version
(``ref.panel_factor_ref``) bit for bit on a few panels before it is
timed.  Diagnostics split the shipped kernel's step and are not checked:
``no_update`` skips the rank-1 update of the slices, ``relaxed_arrive``
drops the release semantics of the cluster barrier's arrive,
``no_column_exchange`` copies no pivot column from another block;
``no_cluster_ops`` (one-block panels only) replaces the cluster barrier
and the remote reads by the block's own; ``clock_probe`` reads block 0's
SM clock over the launch (``clock_mhz``, ``cycles_per_step``).

    python3 tools/k4_variants.py

Prints the card's name and power limit, then one JSON line per check and
per timed shape: ms per launch on the card, 50 launches queued behind a
sleeping kernel so that the host's enqueue time is hidden (each timed
call's enqueue is checked to end before the sleep does); ``|host`` the
same 50 launches back to back without the sleep, so the host's time per
call shows where it is the longer; ``bound_ms`` by bytes at 3.35 TB/s.
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

NO_UPDATE = {"      for (int c = tid; c < width; c += threads) {\n"
             "        const int g = c0 + c;":
             "      for (int c = tid; c < 0; c += threads) {\n"
             "        const int g = c0 + c;"}
LOCAL = {'  asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");\n'
         '  asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");':
         "  __syncthreads();",
         "cluster.map_shared_rank(s_cand + par, lane)": "(s_cand + par)",
         "cluster.map_shared_rank(s_pub + par * K, at / cols)": "(s_pub + par * K)",
         "cluster.map_shared_rank(s_pub_last + par * K, own_last)":
         "(s_pub_last + par * K)"}
# block 0 returns, in place of (sign, logdet), its SM cycles and the
# nanoseconds of the global timer from its start to its end
CLOCK = {"  const cg::cluster_group cluster = cg::this_cluster();":
         "  const cg::cluster_group cluster = cg::this_cluster();\n"
         "  const long long clk0 = clock64();\n"
         "  unsigned long long ns0;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0));',
         "        sign_logdet[0] = sign;\n        sign_logdet[1] = logdet;":
         "        unsigned long long ns1;\n"
         '        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1));\n'
         "        sign_logdet[0] = T(clock64() - clk0);\n"
         "        sign_logdet[1] = T(ns1 - ns0);"}
def persistent_grid(blocks: int) -> dict:
    """The alternative to a cluster: a grid of up to ``blocks`` (at most 32,
    one warp reduces their candidates) ordinary blocks, all resident at once, that keep their slices in shared memory
    for all K steps and meet once a step at a barrier in global memory
    (an atomic counter and a phase flag); the candidates and published
    columns go through global memory (read from the L2)."""
    return {
        "constexpr int kMaxCluster = 16;   // non-portable: above the portable 8":
        f"constexpr int kMaxCluster = {blocks};",
        "__device__ __forceinline__ void cluster_sync() {":
        "__device__ unsigned int g_arrived;\n"
        "__device__ volatile unsigned int g_phase;\n"
        "__device__ __forceinline__ void cluster_sync() {",
        '  asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");\n'
        '  asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");\n':
        "  __threadfence();\n"
        "  __syncthreads();\n"
        "  if (threadIdx.x == 0) {\n"
        "    const unsigned int phase = g_phase;\n"
        "    if (atomicAdd(&g_arrived, 1u) == gridDim.x - 1) {\n"
        "      g_arrived = 0;\n"
        "      __threadfence();\n"
        "      g_phase = phase + 1;\n"
        "    } else {\n"
        "      const long long t0 = clock64();\n"
        "      while (g_phase == phase)\n"
        "        if (clock64() - t0 > (1ll << 34)) __trap();\n"
        "    }\n"
        "    __threadfence();\n"
        "  }\n"
        "  __syncthreads();\n",
        "struct Candidate {\n  unsigned long long key;\n  int i;\n};\n":
        "struct Candidate {\n  unsigned long long key;\n  int i;\n};\n"
        "__device__ Candidate g_cand[kMaxCluster][2];\n"
        "__device__ double g_pub[kMaxCluster][4 * kMaxRows];\n",
        "  const cg::cluster_group cluster = cg::this_cluster();\n"
        "  const int rank = (int)cluster.block_rank();\n"
        "  const int blocks = (int)cluster.num_blocks();":
        "  const int rank = blockIdx.x;\n  const int blocks = gridDim.x;",
        "        if (lane == 0) s_cand[par] = Candidate{key, at};":
        "        if (lane == 0) g_cand[rank][par] = Candidate{key, at};",
        "            s_pub[par * K + i] = slice[i * stride + (at - c0)];":
        "            reinterpret_cast<T*>(g_pub[rank])[par * K + i] =\n"
        "                slice[i * stride + (at - c0)];",
        "          s_pub_last[par * K + i] = slice[i * stride + (last - c0)];":
        "          reinterpret_cast<T*>(g_pub[rank])[(2 + par) * K + i] =\n"
        "              slice[i * stride + (last - c0)];",
        "          const Candidate* cand = cluster.map_shared_rank(s_cand + par, lane);\n"
        "          key = cand->key;\n          at = cand->i;":
        "          key = __ldcg(&g_cand[lane][par].key);\n"
        "          at = __ldcg(&g_cand[lane][par].i);",
        "        const T* col = cluster.map_shared_rank(s_pub + par * K, at / cols);\n"
        "        for (int i = lane; i < K; i += 32) s_col[i] = col[i];":
        "        const T* col = reinterpret_cast<const T*>(g_pub[at / cols]) + par * K;\n"
        "        for (int i = lane; i < K; i += 32) s_col[i] = __ldcg(col + i);",
        "        const T* col = cluster.map_shared_rank(s_pub_last + par * K, own_last);\n"
        "        for (int i = lane; i < K; i += 32) s_last[i] = col[i];":
        "        const T* col =\n"
        "            reinterpret_cast<const T*>(g_pub[own_last]) + (2 + par) * K;\n"
        "        for (int i = lane; i < K; i += 32) s_last[i] = __ldcg(col + i);",
        "  cfg.numAttrs = 1;": "  cfg.numAttrs = 0;",
        "      e = cudaOccupancyMaxActiveClusters(&count, (const void*)kernel, &cfg);":
        "      count = 1;  // a grid of at most 32 blocks is resident at once",
    }


# name: (source substitutions, `kernels.panel_factor` constants, checked)
VARIANTS = {
    "shipped": ({}, {}, True),
    "batch_1": ({"  constexpr int kBatch = 4;": "  constexpr int kBatch = 1;"},
                {}, True),
    "batch_8": ({"  constexpr int kBatch = 4;": "  constexpr int kBatch = 8;"},
                {}, True),
    "max_cluster_8": ({}, {"MAX_CLUSTER": 8}, True),
    "min_cols_128": ({}, {"MIN_COLS": 128}, True),
    "min_cols_512": ({}, {"MIN_COLS": 512}, True),
    "global_memory_slices": ({}, {"STATIC_SMEM": 10 ** 9}, True),
    "persistent_grid_16": (persistent_grid(16), {}, True),
    "persistent_grid_32": (persistent_grid(32), {"MAX_CLUSTER": 32}, True),
    "no_update": (NO_UPDATE, {}, False),
    "relaxed_arrive": ({"barrier.cluster.arrive.release;":
                        "barrier.cluster.arrive.relaxed;"}, {}, False),
    "no_column_exchange": ({"      for (int i = lane; i < K; i += 32) s_col[i] = col[i];":
                            "      for (int i = lane; i < K; i += 32) s_col[i] = T(i == j);"},
                           {}, False),
    # one block only (timed at N = 64): the cluster's barrier and remote
    # reads replaced by the block's own
    "no_cluster_ops": (LOCAL, {}, False),
    "no_cluster_ops_no_update": ({**LOCAL, **NO_UPDATE}, {}, False),
    "clock_probe": (CLOCK, {}, False),
    "no_track": ({"    if (live) keep(v, g, key, at);": ""}, {}, False),
    "no_division": ({"  return pv == T(0) ? T(0) : repro::div_rn(x, pv);":
                     "  return pv == T(0) ? T(0) : repro::mul_rn(x, pv);"},
                    {}, False),
}
ONE_BLOCK = {"no_cluster_ops", "no_cluster_ops_no_update"}
CHECK = [(32, 8192, 8000), (32, 4608, 4608), (32, 462, 400), (32, 64, 64),
         (5, 1000, 900)]
TIME = [(32, 8192), (32, 4608), (32, 1944), (32, 462), (32, 64), (8, 8192),
        (1, 8192), (1, 64)]
SLEEP_CYCLES = 40_000_000   # about 20 ms at the H100's clock


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
    from repro_torch.kernels import panel_factor as k4

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.preferred_linalg_library("cusolver")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_root = ROOT / "build" / "k4_variants"
    procs = {}
    for name, (subs, _, _) in VARIANTS.items():
        if not subs and name != "shipped":
            continue
        d = out_root / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in sources(name, _build.CSRC).items():
            (d / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d.parent / "libpanel_factor.so"), str(d / "panel_factor.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        print(json.dumps({"variant": name,
                          "ptxas": _build._ptxas_summary(log)}), flush=True)
        fn = ctypes.CDLL(str(out_root / name / "libpanel_factor.so")) \
            .repro_panel_factor
        fn.argtypes, fn.restype = _build._ARGTYPES["panel_factor"], ctypes.c_int
        libs[name] = fn
    _build.build()
    defaults = {a: getattr(k4, a) for v in VARIANTS.values() for a in v[1]}

    def use(name):
        _build._functions["panel_factor"] = libs.get(name, libs["shipped"])
        for attr, value in defaults.items():
            setattr(k4, attr, VARIANTS[name][1].get(attr, value))

    def time_ms(fn, iters=50, queued=True):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if queued and host_ms >= sleep_ms:
            raise SystemExit(f"enqueue took {host_ms} ms, longer than the "
                             f"{sleep_ms} ms sleep: raise SLEEP_CYCLES")
        return start.elapsed_time(end) / iters

    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    s1.record()
    torch.cuda.synchronize()
    sleep_ms = s0.elapsed_time(s1)
    print(json.dumps({"sleep_ms": sleep_ms}), flush=True)

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
            for k, n, m0 in CHECK:
                panel = randn(k, n, dtype=dt)
                R, ls, s, _ = k4.panel_factor(panel, m0, 1)
                R0, ls0, s0, _ = ref.panel_factor_ref(panel, m0, 1)
                if not (torch.equal(R, R0) and torch.equal(ls, ls0)
                        and s.item() == s0.item()):
                    raise SystemExit(f"{name} {dt} {(k, n, m0)}: differs "
                                     "from the plain version")
            print(json.dumps({"variant": name, "dtype": str(dt)[6:],
                              "bitwise": True}), flush=True)
    for dt in dtypes:
        size = torch.finfo(dt).bits // 8
        for k, n in TIME:
            panel = randn(k, n, dtype=dt)
            lu_in = panel.mT.contiguous()
            row = {"dtype": str(dt)[6:], "shape": [k, n],
                   "bound_ms": 2 * k * n * size / 3.35e9}
            lib = time_ms(lambda: torch.linalg.lu_factor_ex(lu_in))
            for name in VARIANTS:
                if name in ONE_BLOCK and k4.plan(k, n, dt).cluster != 1:
                    continue
                use(name)
                if name == "clock_probe":
                    _, _, cycles, ns = k4.panel_factor(panel, n)
                    row["clock_mhz"] = cycles.item() / ns.item() * 1e3
                    row["cycles_per_step"] = cycles.item() / k
                    continue
                row[name] = time_ms(lambda: k4.panel_factor(panel, n))
                row[name + "|plan"] = list(k4.plan(k, n, dt)[:3])
            use("shipped")
            row["shipped|host"] = time_ms(lambda: k4.panel_factor(panel, n),
                                          queued=False)
            row["lu_factor_ex"] = (lib + time_ms(
                lambda: torch.linalg.lu_factor_ex(lu_in))) / 2
            row["lu_factor_ex|host"] = time_ms(
                lambda: torch.linalg.lu_factor_ex(lu_in), queued=False)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(json.dumps({"seconds": time.perf_counter() - t0}))
    sys.exit(rc)
