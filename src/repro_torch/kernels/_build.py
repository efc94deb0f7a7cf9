"""Build the CUDA kernels at first use, from the repository's sources only.

Each source under ``kernels/csrc`` is compiled by its own ``nvcc`` (all
started together) into a shared library with a plain C interface, for
Hopper (``sm_90a``), and bound with ``ctypes``.  The libraries go into
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  A failed build raises with nvcc's output;
the ``-Xptxas -v`` summary (registers, shared memory, spills) is printed
once, to stderr, when the kernels are built.

Several processes may load or build the same hash at once (the ranks of
a mesh do): each builds into a fresh temporary directory beside the
final one and renames it into place with `os.replace`, which is atomic.
A directory of that hash therefore exists only complete; the process
that loses the race discards its copy and loads the winner's.  Within a
process a `threading.Lock` guards the loaded functions.

Nothing here runs at import: machines without a card import every
module, and only a wrapper handed a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_ROOT", "build", "digest", "ensure_built",
           "function", "check", "dtype_code", "require_cuda", "stream"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# kernel name (its C entry point is repro_<name>) -> source csrc/<source>.cu
SOURCES = {"rank1_update": "condense_step", "panel_update": "panel_update",
           "fused_step": "fused_step", "panel_factor": "panel_factor",
           "cheb_step": "cheb_step", "cg_step": "cg_step",
           "stencil_mv": "stencil_mv", "matvec": "matvec"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "rank1_update": (_I, _I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P),
    "panel_update": (_I, _I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P),
    "fused_step": (_I, _I, _P, _P, _LL, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                   _P),
    "panel_factor": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                     _LL, _LL, _P),
    "cheb_step": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                  _LL, _LL, _LL, _LL, _LL, _P),
    "cg_step": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                _LL, _LL, _LL, _LL, _LL, _P),
    "stencil_mv": (_I, _P, _P, _I, _P, _P, _LL, _LL, _P),
    "matvec": (_I, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
               _P),
}
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

_lock = threading.Lock()
_functions: dict = {}
_report: dict = {}
loads = 0       # times this process loaded the kernels' libraries (0 or 1)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "cannot build the repro_torch CUDA kernels: nvcc not found "
            f"(CUDA_HOME={CUDA_HOME!r}); CUDA tensors need the kernels, "
            "CPU tensors run the plain versions")
    return nvcc


def digest() -> str:
    """The hash of the sources and nvcc flags that names a build's
    directory."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_summary(log: str) -> dict:
    """Largest register count, shared memory, stack frame (local memory)
    and spill over the template instances in one source's ``-Xptxas -v``
    log."""
    def most(pattern):
        return max((int(v) for v in re.findall(pattern, log)), default=0)
    return {"registers": most(r"Used (\d+) registers"),
            "smem_bytes": most(r"(\d+) bytes smem"),
            "stack_bytes": most(r"(\d+) bytes stack frame"),
            "spill_bytes": max(most(r"(\d+) bytes spill stores"),
                               most(r"(\d+) bytes spill loads")),
            "instances": len(re.findall(r"Compiling entry function", log))}


def _complete(out_dir: Path) -> bool:
    return all((out_dir / f"lib{n}.so").exists() for n in SOURCES)


def _compile(out_dir: Path) -> bool:
    """Run one nvcc per source, all at once, into a temporary directory,
    and rename it to ``out_dir``.  Returns False when another process
    renamed a complete build there first (this one is then discarded)."""
    nvcc = _nvcc()
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f"{out_dir.name}.", dir=out_dir.parent))
    try:
        t0 = time.perf_counter()
        procs = {
            name: subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o",
                 str(tmp / f"lib{name}.so"), str(CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in SOURCES.items()}
        logs = {name: p.communicate()[0] for name, p in procs.items()}
        failed = [name for name, p in procs.items() if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        for name, log in logs.items():
            (tmp / f"{name}.ptxas.txt").write_text(log)
        (tmp / "build_seconds.txt").write_text(
            f"{time.perf_counter() - t0}\n")
        try:
            os.replace(tmp, out_dir)
            return True
        except OSError:
            # the target exists and is not empty: another process won
            if not _complete(out_dir):
                raise
            return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensure_built(out_dir: Path) -> bool:
    """Make ``out_dir`` hold every kernel's library; True when they were
    there already (or another process finished them first)."""
    if _complete(out_dir):
        return True
    return not _compile(out_dir)


def build() -> dict:
    """Build (or load the cached build of) every kernel; returns the
    report: ``{"dir", "cached", "nvcc_seconds", "kernels": {name: ptxas}}``."""
    global loads
    with _lock:
        if _functions:
            return _report
        out_dir = BUILD_ROOT / digest()
        cached = ensure_built(out_dir)
        for name in SOURCES:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            fn = getattr(lib, f"repro_{name}")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            _functions[name] = fn
        loads += 1
        _report.update(
            dir=str(out_dir), cached=cached,
            nvcc_seconds=float((out_dir / "build_seconds.txt").read_text()),
            kernels={n: _ptxas_summary((out_dir / f"{n}.ptxas.txt")
                                       .read_text()) for n in SOURCES})
        if not cached:
            print(f"repro_torch: built {len(SOURCES)} kernels in "
                  f"{_report['nvcc_seconds']:.1f}s into {out_dir}",
                  file=sys.stderr)
            for name, s in _report["kernels"].items():
                print(f"  {name}: {s['registers']} registers, "
                      f"{s['smem_bytes']} B smem, {s['stack_bytes']} B "
                      f"stack, {s['spill_bytes']} B spill "
                      f"({s['instances']} instances)", file=sys.stderr)
        return _report


def function(name: str):
    """The bound C entry point of kernel ``name`` (builds on first use)."""
    build()
    return _functions[name]


def dtype_code(dtype: torch.dtype) -> int:
    return _DTYPE_CODES[dtype]


def _rows_contiguous(t: torch.Tensor) -> bool:
    """A (B, M, N) stack whose matrices are each contiguous, any distance
    apart but not overlapping."""
    b, m, n = t.shape
    return (t.stride(2) == 1 and (m <= 1 or t.stride(1) == n)
            and (b <= 1 or t.stride(0) >= m * n))


def require_cuda(name: str, buffer: torch.Tensor, operands=(), *,
                 batch_stride: bool = False) -> None:
    """Raise unless the launch is one the kernel takes: every tensor
    contiguous on one CUDA device (with ``batch_stride``, a (B, M, N)
    buffer only each matrix), the buffer f32/f64, the operands in the
    buffer's dtype or all bf16."""
    tensors = (buffer, *operands)
    dev = buffer.device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        strided = (batch_stride and t is buffer and t.dim() == 3
                   and _rows_contiguous(t))
        if not (t.is_contiguous() or strided):
            raise ValueError(f"{name}: tensors must be contiguous")
    if buffer.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: buffer dtype {buffer.dtype} unsupported "
                        "(float32 or float64)")
    op_dtypes = {t.dtype for t in operands}
    if len(op_dtypes) > 1 or not op_dtypes <= {buffer.dtype, torch.bfloat16}:
        raise TypeError(f"{name}: operands must all be {buffer.dtype} or "
                        f"all bfloat16, got {sorted(map(str, op_dtypes))}")


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the pointer the C side takes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
