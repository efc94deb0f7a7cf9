"""Plan export/import -- resolve once, serve without planning.

Counterpart of `repro.serve.aot`.  The JAX artifact is a serialized XLA
executable.  The port has nothing of the kind to serialize: its kernels
are ``ctypes`` entry points into the libraries nvcc builds from
``kernels/csrc`` (`repro_torch.kernels._build`), and its engine is an
eager Python loop, which ``torch.export`` cannot trace through.  A port
artifact therefore holds the *resolved plan* in its header: the problem
spec and the explicit typed config (method, schedule, update, panel
width, estimator knobs, ...), so that `load_plan` runs no selector and
no autotune; its payload is empty, and the plan's diagnostics are
derived again from the spec and config, as `repro_torch.plan` derives
them.  What pins it to a machine is the kernel build it was resolved
against, and the header's device fingerprint says which.

File layout (single file, magic-tagged), as in the JAX package but with
the port's own magic, so each package refuses the other's file::

    REPROTORCHPLAN\\x00 | u32 header_len | header JSON | (empty payload)

The header carries the JAX package's keys (``format``, ``method``,
``spec``, ``config``, ``key``, ``padded_n``, ``fingerprint``,
``created_unix``).  The fingerprint is the platform, the card's name,
count and compute capability, the torch and CUDA versions and
``kernel_build``, the hash that names ``build/repro_torch_kernels/<hash>/``
(the kernels' sources and nvcc flags); fields that mean nothing on the
CPU are null.  `load_plan` refuses a mismatch field by field
(`PlanFingerprintError`), loads the kernel build then -- never inside a
request -- and returns an execute-only `LogdetPlan`.

What can be exported: every plan on one device (exact routes, ``ge`` and
the dense estimators, single or batched).  Operator plans hold the
operator's own state and mesh plans run collectives across processes;
both raise `PlanExportError`.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import time
from typing import Any, Dict

import torch

from repro_torch import obs
from repro_torch.core.configs import config_from_dict, config_to_dict
from repro_torch.core.result import Diagnostics
from repro_torch.estimators import ESTIMATOR_METHODS
from repro_torch.estimators.operators.base import resolve_device

__all__ = [
    "PLAN_FORMAT", "PlanExportError", "PlanFingerprintError",
    "device_fingerprint", "export_plan", "load_plan", "read_header",
    "check_fingerprint",
]

PLAN_FORMAT = 1
_MAGIC = b"REPROTORCHPLAN\x00"


class PlanExportError(ValueError):
    """The plan cannot be exported, or the file is not a plan artifact."""


class PlanFingerprintError(ValueError):
    """The artifact was resolved for another device, runtime or kernel
    build."""


def device_fingerprint(device=None) -> Dict[str, Any]:
    """What a plan resolved on ``device`` (None: the card) is pinned to.

    On the card this names the kernel build (the hash of the sources and
    flags), without building it.
    """
    dev = resolve_device(device)
    fp = {"platform": dev.type, "device_kind": None, "device_count": None,
          "capability": None, "torch_version": torch.__version__,
          "cuda_version": None, "kernel_build": None}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        fp.update(device_kind=torch.cuda.get_device_name(dev),
                  device_count=torch.cuda.device_count(),
                  capability=list(torch.cuda.get_device_capability(dev)),
                  cuda_version=torch.version.cuda,
                  kernel_build=_build.digest())
    return fp


def export_plan(plan, path: str) -> str:
    """Write ``plan``'s resolved form to ``path``; returns ``path``.

    Runs nothing and leaves the live plan as it was.  On the card it
    builds (or loads) the kernels first, so the artifact names a build
    that exists.
    """
    if plan.spec.kind == "operator":
        raise PlanExportError(
            "operator plans carry the operator's own state and cannot be "
            "exported; export a dense/batched plan instead")
    if plan._mesh is not None:
        raise PlanExportError(
            "mesh plans run collectives across the ranks' processes and "
            f"cannot be exported (plan: method={plan.method!r}, mesh of "
            f"{plan._mesh.size})")
    method, cfg = plan.method, plan.config
    if plan.device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    key_info = None
    if method in ESTIMATOR_METHODS:
        # the port's counterpart of a PRNG key: a torch.Generator on the
        # plan's device, seeded with the config's seed unless given
        key_info = {"kind": "torch.Generator", "seed": cfg.seed}
    with obs.span("serve.aot.export", method=method, n=plan.spec.n):
        header = {
            "format": PLAN_FORMAT,
            "method": method,
            "spec": dataclasses.asdict(plan.spec),
            "config": config_to_dict(cfg),
            "key": key_info,
            "padded_n": plan.diagnostics.padded_n,
            "fingerprint": device_fingerprint(plan.device),
            "created_unix": time.time(),
        }
        head = json.dumps(header, sort_keys=True).encode()
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<I", len(head)))
            f.write(head)
    obs.inc("serve.aot.exports", method=method)
    return path


def read_header(path: str) -> Dict[str, Any]:
    """Parse and return the JSON header."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise PlanExportError(
                f"{path}: not a repro_torch plan artifact (bad magic)")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
    if header.get("format") != PLAN_FORMAT:
        raise PlanExportError(
            f"{path}: plan format {header.get('format')!r} not supported "
            f"(this build reads format {PLAN_FORMAT})")
    return header


def check_fingerprint(header: Dict[str, Any], path: str, device) -> None:
    """Raise `PlanFingerprintError` naming every field of the artifact's
    fingerprint that differs from ``device``'s in this process."""
    want, have = header["fingerprint"], device_fingerprint(device)
    bad = [f"{k}: artifact={want.get(k)!r} process={have.get(k)!r}"
           for k in sorted(set(want) | set(have))
           if want.get(k) != have.get(k)]
    if bad:
        raise PlanFingerprintError(
            f"{path}: plan was resolved for a different device/runtime -- "
            + "; ".join(bad)
            + ". Re-export on this host (plan.export) or serve on the "
            "hardware and kernel build the artifact was made for.")


def load_plan(path: str, *, validate: bool = True,
              check_device: bool = True, device=None):
    """Load an exported plan onto ``device`` (None: the card, raising
    when there is none) -- no selector, no autotune, and on the card the
    kernel build loaded here, before any request.

    Returns an execute-only `LogdetPlan`: ``value_and_grad`` and an input
    that requires a gradient raise, an estimator plan takes a
    ``generator=`` and no ``probes=``/``lmin=``/``lmax=``, an exact plan
    no generator.  ``check_device=False`` skips the fingerprint check
    (for tests that tamper with headers).
    """
    from repro_torch.core.plan import (
        LogdetPlan, ProblemSpec, _build_forward, _flops_est,
    )

    dev = resolve_device(device)
    header = read_header(path)
    if check_device:
        check_fingerprint(header, path, dev)
    spec = ProblemSpec(**header["spec"])
    try:
        cfg = config_from_dict(header["config"])
    except ValueError as exc:
        raise PlanExportError(f"{path}: {exc}") from None
    method = header["method"]
    with obs.span("serve.aot.load", method=method, n=spec.n):
        if dev.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()
        inner, padded_n = _build_forward(spec, method, cfg, dev, None)
    cols, flops = _flops_est(method, spec, cfg, 1)
    estimator = method in ESTIMATOR_METHODS

    def fwd(a, generator=None, probes=None, lmin=None, lmax=None):
        if getattr(a, "requires_grad", False) and torch.is_grad_enabled():
            raise TypeError(
                "AOT-loaded plans are execute-only: build a local plan "
                "with repro_torch.plan for gradients")
        if probes is not None or lmin is not None or lmax is not None:
            raise TypeError(
                "AOT-loaded plans accept `generator` only; probes and "
                "spectral bounds were resolved at export time")
        if not estimator:
            return inner(a)
        return inner(a, generator=generator)

    plan = LogdetPlan(
        spec=spec, method=method, config=cfg, device=dev, grad=False,
        validate=validate,
        diagnostics=Diagnostics(matvec_cols=cols, flops_est=flops,
                                padded_n=padded_n, device_count=1),
        _fwd=fwd)
    plan._cache["aot_path"] = path
    plan._cache["vag"] = _vag_unavailable
    obs.inc("serve.aot.loads", method=method)
    return plan


def _vag_unavailable(x, generator=None):
    raise NotImplementedError(
        "AOT-loaded plans are execute-only; gradients need a locally "
        "built plan (repro_torch.plan(..., grad=True))")
