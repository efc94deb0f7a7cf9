"""Normalized instruction tables over recorded PyTorch op streams.

Counterpart of `repro.analysis.ir`.  The JAX package lowers a program
without running it and parses the StableHLO / HLO text; eager PyTorch has
no program text, so the port RECORDS one call instead: `record(fn,
*args)` (or ``with Recorder() as mod:``) runs ``fn`` under a
`torch.utils._python_dispatch.TorchDispatchMode`, which sees every ATen
op the call dispatches, and a `torch.overrides.TorchFunctionMode`, which
sees the Python-level host reads (``item``, ``tolist``, ``numpy``,
``cpu`` and the ``bool``/``float``/``int``/``index`` conversions).

Each `Instruction` records the opcode (``aten.<name>`` with the overload
dropped; a collective in HLO spelling, ``broadcast``/``all-reduce``/...;
``kernel.<name>`` for a kernel entry; ``host.<method>`` for a host
read), the operand and result shapes with JAX dtype spelling (``f32``,
``f64``, ``bf16``), the device types the data comes from and goes to,
the scope ancestry and, for a host read, the port's function that made
it.  It keeps no tensor reference: a full-width recording holds some
250k rows.

- **Scopes** are the `torch.profiler.record_function` ranges that
  `repro_torch.obs.stage` and `obs.span` open in ``trace`` mode (the
  dispatcher sees ``profiler._record_function_enter_new`` / ``_exit``).
  With obs ``off`` or ``metrics`` a stage is a shared no-op and a
  recording has no scopes, as lowered StableHLO has none.
- **Kernel launches** are ctypes calls the dispatcher never sees, so
  `repro_torch.kernels.ops` reports each kernel entry to the active
  recorder (`kernel`) as ``kernel.<name>`` with its operands' shapes,
  under the names of `ops.launch_counts`.  On the CPU the plain
  version's ATen ops follow the record; on the card the record is the
  launch.
- **Host reads** are the Python-level reads above (the ATen ops inside
  one are not recorded again), an ``aten._local_scalar_dense`` made
  below Python, and an ``aten._to_copy`` / ``aten.copy_`` from a device
  to the host.  The same calls are recorded on both devices.
- **Collectives** are the ``c10d`` ops the process group dispatches
  (``broadcast_``, ``allreduce_``, ...), named in HLO spelling.

`collective_bytes` and `roofline` are the JAX functions over a recorded
`Module`; `HW` holds the H100's data-sheet rates.
"""
from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "Shape", "Instruction", "Module", "Recorder", "record", "shape_bytes",
    "collective_bytes", "roofline", "HW", "CollectiveStats",
    "COLLECTIVE_OPS", "collective_payload_bytes", "dtype_name",
    "active_recorder",
]

# NVIDIA H100 SXM data sheet (dense): bf16 tensor-core peak, HBM3, and
# NVLink 4 per direction (the JAX key names: the roofline reads them)
HW = {
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "ici_bw": 450e9,               # B/s per direction (NVLink)
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute", "broadcast")

# c10d op -> HLO spelling (the port's mesh issues broadcast and all_reduce
# only, core/mesh.py)
_C10D_OPCODES = {
    "broadcast_": "broadcast", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

_HOST_OPCODES = ("aten._local_scalar_dense",)
_COPY_OPCODES = ("aten._to_copy", "aten.copy_")


def dtype_name(dt) -> str:
    """JAX spelling of a torch dtype (``torch.float32`` -> ``"f32"``)."""
    return _DTYPE_NAMES.get(dt, str(dt).removeprefix("torch."))


@dataclass(frozen=True)
class Shape:
    """One result/operand: dtype (JAX spelling) + dims."""
    dtype: str
    dims: Tuple[int, ...] = ()

    @property
    def bytes(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n * _DTYPE_BYTES.get(self.dtype, 0)


def shape_bytes(shapes: Iterable[Shape]) -> int:
    """Total byte size of a flattened result or operand list."""
    return sum(s.bytes for s in shapes)


@dataclass(slots=True)
class Instruction:
    """One recorded op.

    ``name`` is ``%<line_no>``, the index in the recording; ``device`` the
    device type
    the op reads (its first tensor operand's; a copy's source) and
    ``result_device`` the one it writes; ``scopes`` the open
    `record_function` ranges, outermost first; ``site`` the port's
    ``module.py:function`` that made a host read (else "").  The JAX
    row's ``operands`` (names) and ``custom_call_target`` have no
    counterpart: a recorded op carries its operands' shapes, and PyTorch
    has no custom calls.
    """
    opcode: str
    result_shapes: Tuple[Shape, ...] = ()
    operand_shapes: Tuple[Shape, ...] = ()
    scopes: Tuple[str, ...] = ()
    line_no: int = 0
    device: str = ""
    result_device: str = ""
    site: str = ""

    @property
    def name(self) -> str:
        return f"%{self.line_no}"

    @property
    def result_bytes(self) -> int:
        return shape_bytes(self.result_shapes)

    @property
    def operand_bytes(self) -> int:
        return shape_bytes(self.operand_shapes)

    @property
    def host_read(self) -> bool:
        """Does this op bring device data to the host?  A Python-level
        read, ``_local_scalar_dense``, or a copy from a device to the
        host."""
        if self.opcode.startswith("host.") or self.opcode in _HOST_OPCODES:
            return True
        return (self.opcode in _COPY_OPCODES and self.result_device == "cpu"
                and self.device not in ("", "cpu", "meta"))

    @property
    def raw(self) -> str:
        """Text form, the allowlist's ``code`` matcher reads it."""
        def fmt(shapes):
            return ",".join(f"{s.dtype}[{'x'.join(map(str, s.dims))}]"
                            for s in shapes)
        text = f"{self.name} = {self.opcode}({fmt(self.operand_shapes)})"
        if self.result_shapes:
            text += f" -> {fmt(self.result_shapes)}"
        if self.device:
            text += f" @{self.device}"
            if self.result_device and self.result_device != self.device:
                text += f"->{self.result_device}"
        if self.scopes:
            text += f" [{'/'.join(self.scopes)}]"
        if self.site:
            text += f" in {self.site}"
        return text

    def in_scope(self, name: str) -> bool:
        return any(name == s or s.endswith("/" + name) for s in self.scopes)


@dataclass
class Module:
    """Recorded instruction table of one call.  ``entered`` holds every
    scope opened during the recording, also those no op ran inside."""
    dialect: str = "torch"
    instructions: List[Instruction] = field(default_factory=list)
    entered: set = field(default_factory=set)

    def find(self, opcode_prefix: str) -> List[Instruction]:
        """Instructions whose opcode starts with ``opcode_prefix``."""
        return [i for i in self.instructions
                if i.opcode.startswith(opcode_prefix)]

    def collectives(self) -> List[Instruction]:
        return [i for i in self.instructions if i.opcode in COLLECTIVE_OPS]

    def kernel_counts(self) -> Dict[str, int]:
        """``kernel.<name>`` records by name (the keys of
        `repro_torch.kernels.ops.launch_counts`)."""
        out: Dict[str, int] = {}
        for i in self.instructions:
            if i.opcode.startswith("kernel."):
                name = i.opcode[len("kernel."):]
                out[name] = out.get(name, 0) + 1
        return out

    def host_reads(self) -> List[Instruction]:
        return [i for i in self.instructions if i.host_read]

    def scope_names(self) -> set:
        names = set(self.entered)
        for i in self.instructions:
            names.update(i.scopes)
        return names


# --------------------------------------------------------------------------
# the recorder
# --------------------------------------------------------------------------

_active = threading.local()


def active_recorder() -> Optional["Recorder"]:
    """The recorder active in this thread, if any."""
    return getattr(_active, "rec", None)


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP_DIRS = (os.path.join(_PKG_DIR, "analysis"),)

_HOST_READ_FUNCS = {
    torch.Tensor.item: "item", torch.Tensor.tolist: "tolist",
    torch.Tensor.numpy: "numpy", torch.Tensor.cpu: "cpu",
    torch.Tensor.__bool__: "bool", torch.Tensor.__float__: "float",
    torch.Tensor.__int__: "int", torch.Tensor.__index__: "index",
}


def _site() -> str:
    """``module.py:function`` of the innermost port frame outside this
    package (``core/plan.py:_validate_spd_like``), else the innermost
    frame's file name."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG_DIR) and not path.startswith(_SKIP_DIRS):
            rel = os.path.relpath(path, _PKG_DIR).replace(os.sep, "/")
            return f"{rel}:{f.f_code.co_name}"
        if first is None and not path.startswith(_SKIP_DIRS) \
                and "torch" + os.sep not in path:
            first = f"{os.path.basename(path)}:{f.f_code.co_name}"
        f = f.f_back
    return first or ""


class _HostReads(TorchFunctionMode):
    """The Python-level host reads, on any device."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _HOST_READ_FUNCS.get(func) if args else None
        if name is None or not isinstance(args[0], torch.Tensor):
            return func(*args, **kwargs)
        self.rec._host_read(name, args[0])
        self.rec._nested += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.rec._nested -= 1


def _dispatch(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    rec = self.rec
    op = rec._opcode(func)
    if op is None:                           # a profiler scope
        name = func.__name__
        if name.startswith("_record_function_enter"):
            rec._scopes.append(str(args[0]))
            rec._scope_t = tuple(rec._scopes)
            rec.module.entered.add(str(args[0]))
        elif name.startswith("_record_function_exit") and rec._scopes:
            rec._scopes.pop()
            rec._scope_t = tuple(rec._scopes)
        return out
    if not rec._nested:
        # the function mode would see each .shape/.device read of _op
        with torch._C.DisableTorchFunction():
            rec._op(op, func, args, kwargs, out)
    return out


class _Ops(TorchDispatchMode):
    """Every dispatched ATen and c10d op, and the profiler's scopes."""

    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec


# set after the class is made: the handler runs once an op and is never
# compiled, so it goes without the torch._disable_dynamo wrapper that
# TorchDispatchMode's __init_subclass__ puts around it
_Ops.__torch_dispatch__ = _dispatch


def _tensors(x, acc: list) -> list:
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, acc)
    return acc


def _device(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else t.device.type


class Recorder:
    """Record one call's op stream into a `Module`::

        with Recorder() as mod:
            res = plan(a)

    Recorders nest (the inner one records alone) and are per thread.
    ``ops=False`` records the scopes alone (``Module.entered``): no
    instruction, no host read, no kernel record, at a fraction of the
    cost, for a pass that reads nothing else.
    """

    def __init__(self, ops: bool = True):
        self.module = Module()
        self._scopes: List[str] = []
        self._scope_t: Tuple[str, ...] = ()
        # >0 while nothing below is to be recorded as an op: inside a
        # Python-level host read, or always with ops=False
        self._nested = 0 if ops else 1
        self._shapes: Dict[tuple, Shape] = {}
        self._opcodes: Dict[object, Optional[str]] = {}
        self._modes = (_HostReads(self), _Ops(self)) if ops else (_Ops(self),)
        self._prev = None
        self._prev_ops = None

    # -- context ----------------------------------------------------------

    def __enter__(self) -> Module:
        from repro_torch.kernels import ops
        self._prev = active_recorder()
        self._prev_ops = ops._recorder
        _active.rec = self
        ops._recorder = self
        for m in self._modes:
            m.__enter__()
        return self.module

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for m in reversed(self._modes):
            m.__exit__(*exc)
        _active.rec = self._prev
        ops._recorder = self._prev_ops
        return False

    # -- what the modes and the kernel hook report -------------------------

    def kernel(self, name: str, operands) -> None:
        """One kernel entry (`repro_torch.kernels.ops`), ``operands`` the
        tensors handed to the kernel or its plain version."""
        if active_recorder() is not self or self._nested:
            return                           # another thread's, or no ops
        ts = _tensors(operands, [])
        self._add(f"kernel.{name}", ts, (), ts[0].device.type if ts else "",
                  "", "")

    def _host_read(self, method: str, t: torch.Tensor) -> None:
        self._add(f"host.{method}", [t], (), t.device.type, "cpu", _site())

    def _opcode(self, func) -> Optional[str]:
        op = self._opcodes.get(func, False)
        if op is False:
            ns = func.namespace
            if ns == "profiler":
                op = None
            elif ns == "c10d":
                base = func.__name__.split(".")[0]
                op = _C10D_OPCODES.get(base, f"c10d.{base}")
            else:
                op = f"{ns}.{func.__name__.split('.')[0]}"
            self._opcodes[func] = op
        return op

    def _op(self, op: str, func, args, kwargs, out) -> None:
        ins = _tensors(args, [])
        if kwargs:
            _tensors(tuple(kwargs.values()), ins)
        outs = _tensors(out, [])
        if op == "aten.copy_" and len(ins) >= 2:
            src, dst = _device(ins[1]), _device(ins[0])
        else:
            src = _device(ins[0]) if ins else \
                (_device(outs[0]) if outs else "")
            dst = _device(outs[0]) if outs else src
        site = _site() if (op in _HOST_OPCODES or (
            op in _COPY_OPCODES and dst == "cpu"
            and src not in ("", "cpu", "meta"))) else ""
        self._add(op, ins, outs, src, dst, site)

    def _shape(self, t: torch.Tensor) -> Shape:
        key = (t.dtype, t.shape)
        s = self._shapes.get(key)
        if s is None:
            s = self._shapes[key] = Shape(dtype_name(t.dtype), tuple(t.shape))
        return s

    def _add(self, op, ins, outs, device, result_device, site) -> None:
        instrs = self.module.instructions
        shape = self._shape
        instrs.append(Instruction(
            op, tuple([shape(t) for t in outs]),
            tuple([shape(t) for t in ins]), self._scope_t, len(instrs),
            device, result_device, site))


def record(fn, *args, **kwargs) -> Module:
    """Run ``fn(*args, **kwargs)`` once under a `Recorder` and return the
    recorded `Module` (the stand-in for the JAX package's lower-then-parse)."""
    with Recorder() as mod:
        fn(*args, **kwargs)
    return mod


# --------------------------------------------------------------------------
# collective accounting + roofline
# --------------------------------------------------------------------------

def collective_payload_bytes(instr: Instruction) -> float:
    """Per-device wire bytes of one collective (ring conventions; a
    broadcast moves its buffer).  A recorded op carries its operands'
    shapes, so no name table is needed (the JAX function's ``sizes``)."""
    base = instr.opcode
    out_bytes = instr.result_bytes
    in_bytes = instr.operand_bytes
    if base == "all-reduce":
        return 2 * in_bytes
    if base == "all-gather":
        return max(out_bytes - in_bytes, out_bytes // 2)
    if base == "reduce-scatter":
        return max(in_bytes - out_bytes, in_bytes // 2)
    return max(in_bytes, out_bytes)     # broadcast, all-to-all, permute


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    wire_bytes: float = 0.0          # per device
    by_op: Dict[str, float] = field(default_factory=dict)


def collective_bytes(module: Module) -> CollectiveStats:
    """Per-device wire bytes of a recorded `Module`'s collectives.  The
    recording ran every loop iteration, so the count is exact (the JAX
    function counts a while body once)."""
    stats = CollectiveStats()
    for instr in module.collectives():
        base = instr.opcode
        wire = collective_payload_bytes(instr)
        stats.counts[base] = stats.counts.get(base, 0) + 1
        stats.by_op[base] = stats.by_op.get(base, 0.0) + wire
        stats.wire_bytes += wire
    return stats


def roofline(*, flops: float, hbm_bytes: float, wire_bytes_per_chip: float,
             chips: int, hw: Dict[str, float] = HW) -> Dict[str, float]:
    """Three-term roofline (seconds) + bottleneck."""
    terms = {
        "compute_s": flops / (chips * hw["peak_flops_bf16"]),
        "memory_s": hbm_bytes / (chips * hw["hbm_bw"]),
        "collective_s": wire_bytes_per_chip / hw["ici_bw"],
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["step_s_lower_bound"] = max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])
    return terms
