"""Checker passes over recorded op streams.

Counterpart of `repro.analysis.passes`, with the same pass ids.  Each
pass proves one structural claim about a recorded call (`analysis.ir`):

  ``no-dense-factorization``     matrix-free programs, forward and
                                 backward, run no dense factorization,
                                 solve or inverse: no ``aten.linalg_*``
                                 LU, Cholesky, triangular solve, inverse,
                                 QR, SVD, eig/eigh, slogdet or det, and no
                                 K4 (``kernel.panel_factor``)
  ``no-host-callback``           with obs ``off`` or ``metrics`` the call
                                 makes no host read beyond what its route
                                 is entitled to (`expected_host_reads`):
                                 the exact engine loops none
  ``collective-payload-budget``  every mesh collective moves at most its
                                 analytic payload; inside
                                 ``engine.mesh_tail`` O(P^2)
  ``dtype-discipline``           no f32/bf16/f16 -> f64 ``_to_copy`` in a
                                 sub-f64 program; with precision="bf16"
                                 some contraction takes a bf16 operand
  ``stage-coverage``             each engine route's `obs.stage` scopes
                                 are present exactly when its flags and
                                 geometry say so

A pass is ``run(module, ctx) -> [Finding]`` registered under its id;
`run_passes` drives any subset.  Scopes exist only when the call was
recorded in ``trace`` mode (a stage is a shared no-op otherwise), so a
pass that reads them declares ``wants="scopes"``, the counterpart of the
JAX ``wants="hlo"``: the audit drivers record such a call a second time
under ``trace``.

The JAX package's ``exportable-custom-calls`` has no torch meaning: it
screens an exported XLA executable for host function pointers, and the
port's plan artifact holds no program (`repro_torch.serve.aot`: the
resolved plan and a fingerprint).  It is not registered, so naming it
fails as an unknown pass does.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.ir import Instruction, Module
from repro_torch.analysis.report import AuditReport, Finding

__all__ = [
    "AuditContext", "PASSES", "register_pass", "run_passes",
    "expected_engine_stages", "expected_host_reads", "DEFAULT_PASS_IDS",
]

# dense factorizations, solves and inverses: substrings of the ATen op
# names the linalg front ends dispatch (torch.linalg.inv ->
# aten.linalg_inv_ex, torch.linalg.slogdet -> aten._linalg_slogdet, ...)
_FACTORIZATION_OPS = ("lu_factor", "linalg_lu", "lu_solve", "lu_unpack",
                      "cholesky", "solve_triangular", "triangular_solve",
                      "linalg_inv", "inverse", "linalg_qr", "geqrf",
                      "orgqr", "ormqr", "svd", "linalg_eig", "slogdet",
                      "linalg_det", "logdet", "linalg_solve", "ldl_factor",
                      "lstsq", "pinv")
# symmetric eigensolvers: a factorization of A when their matrix has A's
# side; SLQ's Gauss quadrature on its (num_steps x num_steps) Lanczos
# tridiagonal is the estimator's own arithmetic (the JAX pass's target
# list names sytrd, A's tridiagonal reduction, and not syevd)
_EIGH_OPS = ("eigh", "eigvalsh")
_FACTORIZATION_KERNELS = ("kernel.panel_factor",)

_MATRIX_FREE = ("chebyshev", "slq")


@dataclass(frozen=True)
class AuditContext:
    """What the audited call *is* -- the pass inputs.

    The JAX fields (``label``, ``method``, ``kind``, the engine axes,
    ``n``/``devices``/``itemsize``, ``dtype``, ``obs_mode``,
    ``matrix_free``, ``expected_stages``), plus what the port's
    entitlements and stage map read: ``shrink``/``min_size`` (the staged
    schedule's geometry), ``validate`` (a dense estimator plan screens its
    input: one host read) and ``cg_iters`` (the backward's CG iterations,
    one host read each, plus the test that stops the loop).
    """
    label: str = ""
    method: str = ""
    kind: str = "forward"
    schedule: Optional[str] = None
    update: Optional[str] = None
    lookahead: bool = False
    panel_k: int = 32
    fused: bool = False
    precision: Optional[str] = None
    n: int = 0
    devices: int = 1
    itemsize: int = 8
    dtype: str = "float64"
    obs_mode: str = "off"
    matrix_free: bool = False
    expected_stages: Optional[Dict[str, bool]] = None
    shrink: float = 0.75
    min_size: int = 64
    validate: bool = False
    cg_iters: Optional[int] = None


@dataclass
class Pass:
    id: str
    run: Callable[[Module, AuditContext], List[Finding]]
    description: str
    wants: str = "any"          # "scopes" (a trace-mode recording) | "any"


PASSES: Dict[str, Pass] = {}


def register_pass(pass_id: str, description: str, wants: str = "any"):
    def deco(fn):
        PASSES[pass_id] = Pass(id=pass_id, run=fn, description=description,
                               wants=wants)
        return fn
    return deco


def run_passes(module: Module, ctx: AuditContext,
               pass_ids: Optional[Tuple[str, ...]] = None) -> AuditReport:
    """Run the selected passes over a recorded `Module`."""
    if not isinstance(module, Module):
        raise TypeError(f"run_passes takes a recorded Module "
                        f"(analysis.ir.record), got {type(module).__name__}")
    report = AuditReport()
    for pid in (pass_ids if pass_ids is not None else tuple(PASSES)):
        p = PASSES[pid]
        findings = [replace(f, context=f.context or ctx.label)
                    for f in p.run(module, ctx)]
        report.findings.extend(findings)
        report.passes_run.append(pid)
    if ctx.label:
        report.contexts.append(ctx.label)
    return report


def _finding(pid: str, instr: Instruction, message: str,
             severity: str = "error") -> Finding:
    return Finding(pass_id=pid, severity=severity, message=message,
                   where=instr.name, code=instr.raw)


# --------------------------------------------------------------------------
# the passes
# --------------------------------------------------------------------------

def _factorization(i: Instruction, n: int) -> bool:
    op = i.opcode
    if op in _FACTORIZATION_KERNELS:
        return True
    if not op.startswith("aten."):
        return False
    if any(m in op for m in _EIGH_OPS):
        side = max((s.dims[-1] for s in i.operand_shapes if s.dims),
                   default=0)
        return n <= 0 or side >= n
    return any(m in op for m in _FACTORIZATION_OPS)


@register_pass(
    "no-dense-factorization",
    "matrix-free programs run no dense factorization, solve or inverse "
    "(Han et al. estimator contract)")
def _no_dense_factorization(mod: Module, ctx: AuditContext) -> List[Finding]:
    if not (ctx.matrix_free or ctx.method in _MATRIX_FREE):
        return []
    return [_finding(
        "no-dense-factorization", i,
        f"dense {i.opcode} in a matrix-free {ctx.method or 'estimator'} "
        f"{ctx.kind} program")
        for i in mod.instructions if _factorization(i, ctx.n)]


def expected_host_reads(ctx: AuditContext) -> Dict[str, int]:
    """Host reads a route is entitled to in one recorded call, by the
    port's function that makes them (``module.py:function``).

    Worked out from the code, as `_collective_budgets` is:

      * the exact engine and the baselines: none.  The step loops keep
        the pivot, the sign and the log on the device
        (``core/engine.py``: no ``.item()``, ``float()`` or ``bool()`` of
        a device tensor inside the loops);
      * a dense estimator plan that validates its input
        (``validate=True``): one read of three scalars
        (``core/plan.py:_validate_spd_like``);
      * CG (the estimators' backward pullback): one read per iteration,
        plus the one that stops the loop
        (``estimators/operators/solve.py:cg_solve``; the JAX package keeps
        that loop on the device);
      * everything else: none.
    """
    reads: Dict[str, int] = {}
    if ctx.method in _MATRIX_FREE and ctx.validate:
        reads["core/plan.py:_validate_spd_like"] = 1
    if ctx.cg_iters is not None:
        reads["estimators/operators/solve.py:cg_solve"] = ctx.cg_iters + 1
    return reads


@register_pass(
    "no-host-callback",
    "with observability off or metrics, a call makes no host read beyond "
    "its route's entitlement (telemetry must be structurally absent, and "
    "the exact engine loops never wait on the host)")
def _no_host_callback(mod: Module, ctx: AuditContext) -> List[Finding]:
    if ctx.obs_mode not in ("off", "metrics"):
        return []           # trace mode copies telemetry to the host
    allowed = expected_host_reads(ctx)
    by_site: Dict[str, List[Instruction]] = {}
    for i in mod.host_reads():
        by_site.setdefault(i.site, []).append(i)
    out = []
    for site, reads in by_site.items():
        extra = len(reads) - allowed.get(site, 0)
        if extra <= 0:
            continue
        first = reads[allowed.get(site, 0)]
        out.append(Finding(
            pass_id="no-host-callback", severity="error",
            message=f"{extra} host read(s) ({first.opcode}) in "
                    f"{site or 'an unknown site'} beyond the route's "
                    f"entitlement of {allowed.get(site, 0)}, in a call "
                    f"recorded with obs={ctx.obs_mode!r}: the host waits "
                    "on the device inside the path",
            where=site or first.name, code=first.raw))
    return out


def _collective_budgets(ctx: AuditContext) -> Dict[str, int]:
    """Analytic per-collective payload caps for a mesh-schedule engine
    call (bytes, max(operand, result) convention), the JAX package's.

    The loop broadcasts move one pivot row and its column index, or one
    ``(K, N)`` panel and its K indices -- O(k * N) bytes; the tail's
    all_reduce moves the (P, P + 2) block of live rows and partials --
    O(P^2).  64 bytes of slop cover index/sign scalars riding along.
    The port's loop collective is a broadcast (`core.mesh`), held to the
    loop's all-reduce budget.
    """
    k = ctx.panel_k if ctx.update == "panel" else 1
    p, n, isz = max(ctx.devices, 1), ctx.n, ctx.itemsize
    loop = isz * k * (n + 2 * k) + 64
    return {
        "all-gather": isz * (p * max(p, k) + p) + 64,
        "all-reduce": loop,
        "reduce-scatter": loop,
        "all-to-all": loop,
        "collective-permute": loop,
        "broadcast": loop,
    }


@register_pass(
    "collective-payload-budget",
    "every mesh-schedule collective payload stays within the route's "
    "analytic bound -- the tail is O(P^2) bytes, never O(N*P)")
def _collective_payload_budget(mod: Module,
                               ctx: AuditContext) -> List[Finding]:
    if ctx.schedule != "mesh" or ctx.n <= 0:
        return []
    budgets = _collective_budgets(ctx)
    tail_budget = ctx.itemsize * (ctx.devices * ctx.devices
                                  + 2 * ctx.devices) + 64
    out = []
    for i in mod.collectives():
        base = i.opcode
        payload = max(i.result_bytes, i.operand_bytes)
        budget = budgets.get(base)
        if i.in_scope("engine.mesh_tail"):
            budget = tail_budget
        if budget is None or payload <= budget:
            continue
        out.append(_finding(
            "collective-payload-budget", i,
            f"{base} moves {payload} bytes, analytic bound is {budget} "
            f"(n={ctx.n}, P={ctx.devices}, k={ctx.panel_k}, "
            f"update={ctx.update}) -- a live-data slice is missing "
            "before the collective"))
    return out


_32BIT = ("float32", "bfloat16", "float16")
_NARROW = {"f32", "bf16", "f16"}
# contractions: ATen products and the kernels that multiply
_CONTRACTION_OPS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
                    "aten.addr", "aten.mul", "aten.matmul",
                    "kernel.rank1_update", "kernel.panel_update",
                    "kernel.fused_step", "kernel.panel_factor")


@register_pass(
    "dtype-discipline",
    "no silent f32/bf16/f16 -> f64 promotions in a sub-f64 program; with "
    "precision='bf16' some contraction takes bf16 operands "
    "(quantize-then-upcast-before-multiply is inert)")
def _dtype_discipline(mod: Module, ctx: AuditContext) -> List[Finding]:
    out: List[Finding] = []
    if ctx.precision == "bf16":
        has_bf16_mul = any(
            any(s.dtype == "bf16" for s in i.operand_shapes)
            for i in mod.instructions if i.opcode in _CONTRACTION_OPS)
        if not has_bf16_mul:
            out.append(Finding(
                pass_id="dtype-discipline", severity="error",
                message="bf16-silent-upcast: precision='bf16' program "
                        "runs no bf16-operand contraction -- operands "
                        "were promoted back to full precision before "
                        "the multiply, so the mixed-precision route is "
                        "inert",
                where="precision=bf16"))
    if ctx.dtype not in _32BIT:
        return out          # an f64 plan is entitled to f64 arithmetic
    for i in mod.instructions:
        if i.opcode != "aten._to_copy":
            continue
        src = {s.dtype for s in i.operand_shapes}
        dst = {s.dtype for s in i.result_shapes}
        if "f64" in dst and src & _NARROW:
            out.append(_finding(
                "dtype-discipline", i,
                f"silent upcast {sorted(src & _NARROW)} -> f64 in a "
                f"{ctx.dtype} program -- a dtype-less constructor or "
                "widening helper is promoting the pipeline"))
    if not out:
        # no explicit casts: any f64-valued op at all still means the
        # program left its precision (weaker signal -> warning)
        for i in mod.instructions:
            if any(s.dtype == "f64" for s in i.result_shapes):
                out.append(_finding(
                    "dtype-discipline", i,
                    f"f64-valued {i.opcode} in a {ctx.dtype} program",
                    severity="warning"))
                break
    return out


# --------------------------------------------------------------------------
# stage coverage
# --------------------------------------------------------------------------

def _blocked_work(m: int, k: int, panel: bool) -> Tuple[int, int]:
    """(rank-1 steps, panels) of `engine.blocked_full` (or
    `condense_full`) on an m-sided buffer."""
    if m <= 1:
        return 0, 0
    if not panel or m <= k:
        return m - 1, 0
    p = (m - 1) // k
    return m - 1 - p * k, p


def _engine_work(ctx: AuditContext) -> Tuple[int, int]:
    """(rank-1 steps, panels) one rank runs in its main loop (the mesh
    tail's P - 1 steps not included), mirroring `core.engine`."""
    n, k = ctx.n, max(ctx.panel_k, 1)
    panel = ctx.update == "panel"
    if ctx.schedule == "mesh":
        p = max(ctx.devices, 1)
        rows = n // p
        if rows < 1:
            return 0, 0
        if not panel:
            return (rows - 1) * p, 0
        r = (rows - 1) // k
        return (rows - 1 - r * k) * p, r * p
    if ctx.schedule == "serial" or n <= ctx.min_size:
        return _blocked_work(n, k, panel)
    from repro_torch.core.engine import stage_schedule
    rank1 = panels = 0
    for size, steps in stage_schedule(n, ctx.shrink, ctx.min_size):
        if size - steps <= 1:
            r1, pn = _blocked_work(size, k, panel)
            return rank1 + r1, panels + pn
        if panel and steps >= k:
            panels, rank1 = panels + steps // k, rank1 + steps % k
        else:
            rank1 += steps
    return rank1, panels


def expected_engine_stages(ctx: AuditContext) -> Dict[str, bool]:
    """Which `obs.stage` scopes MUST (True) / MUST NOT (False) open in a
    recorded engine call, given its flags and geometry.

    The JAX package's seven names, plus the port's panel stages
    ``engine.panel_factor``, ``engine.panel_apply`` and
    ``engine.panel_swap_gather``.  Derived from `core.engine`:

      * ``engine.pivot``/``engine.swap``/``engine.update``: present iff a
        unfused rank-1 step runs.  The rank-1 mesh lookahead selects each
        pivot inside ``engine.lookahead_factor`` (the first one before
        the loop, in no stage), so there only the (P, P) tail's steps at
        P >= 2 bring ``engine.pivot`` -- the JAX map's rule.
      * ``engine.fused_step``: fused (serial/staged) and a rank-1 step.
      * ``engine.panel_factor``/``engine.panel_apply``: a panel runs;
        ``engine.panel_swap_gather`` also needs ``fused``.
      * ``engine.mesh_tail``: the mesh schedule; ``engine.broadcast``: a
        mesh step or panel runs.
      * ``engine.lookahead_factor``: lookahead and at least two steps
        (rank1) or panels (panel) in the loop: the port early-applies the
        NEXT step on its owner, so a single one has nothing to pipeline.

    Where the port differs from the JAX map: the JAX map keys the pivot,
    swap and update stages to the schedule alone, and its lookahead to
    one owned panel per device (``(n/P - 1) // k >= 1``) or ``n >= 2``
    (rank1).  At the default grid's geometries the two maps agree on the
    JAX names; they part only where a route runs no rank-1 step, or one
    step or panel in all.
    """
    mesh = ctx.schedule == "mesh"
    p = max(ctx.devices, 1)
    rank1, panels = _engine_work(ctx)
    fused = bool(ctx.fused) and not mesh
    tail = mesh and p >= 2              # the (P, P) tail's rank-1 steps
    steps = rank1 > 0 or tail
    if mesh and ctx.lookahead:
        la = (panels if ctx.update == "panel" else rank1) >= 2
    else:
        la = False
    rank1_la = mesh and ctx.lookahead and ctx.update == "rank1"
    pivot = tail or (rank1 > 0 and not fused and not rank1_la)
    return {
        "engine.pivot": pivot,
        "engine.swap": steps and not fused,
        "engine.update": steps and not fused,
        "engine.fused_step": fused and rank1 > 0,
        "engine.mesh_tail": mesh,
        "engine.broadcast": mesh and rank1 + panels > 0,
        "engine.lookahead_factor": la,
        "engine.panel_factor": panels > 0,
        "engine.panel_apply": panels > 0,
        "engine.panel_swap_gather": fused and panels > 0,
    }


@register_pass(
    "stage-coverage",
    "each engine schedule's scopes open in the recorded call exactly "
    "when its flags say so (no inert flags, no phantom stages)",
    wants="scopes")
def _stage_coverage(mod: Module, ctx: AuditContext) -> List[Finding]:
    if (ctx.method != "exact" and ctx.expected_stages is None) or ctx.n < 2:
        return []
    expected = ctx.expected_stages
    if expected is None:
        expected = expected_engine_stages(ctx)
    present = mod.scope_names()
    out = []
    for stage, want in sorted(expected.items()):
        have = stage in present
        if want and not have:
            out.append(Finding(
                pass_id="stage-coverage", severity="error",
                message=f"stage {stage!r} missing from the recorded call "
                        f"although the route's flags require it "
                        f"(schedule={ctx.schedule}, update={ctx.update}, "
                        f"lookahead={ctx.lookahead}) -- the flag is inert",
                where=stage))
        elif not want and have:
            out.append(Finding(
                pass_id="stage-coverage", severity="error",
                message=f"stage {stage!r} present although the route's "
                        f"flags forbid it (schedule={ctx.schedule}, "
                        f"update={ctx.update}, lookahead={ctx.lookahead})",
                where=stage))
    return out


# the default pass set the audit drivers run (the JAX package's, whose
# opt-in export screen has no torch meaning)
DEFAULT_PASS_IDS = ("no-dense-factorization", "no-host-callback",
                    "collective-payload-budget", "dtype-discipline",
                    "stage-coverage")
