"""repro_torch.analysis -- audits that prove plan invariants over a
recorded call, and AST lint over the source.

Counterpart of `repro.analysis`.  Layers (each usable on its own):

  `repro_torch.analysis.ir`      a recorded call -> normalized instruction
                                 table (opcode, shapes, dtypes, devices,
                                 scope ancestry, host reads, kernel
                                 records, collectives); the stand-in for
                                 the JAX package's HLO parser
  `repro_torch.analysis.passes`  registered checker passes over recorded
                                 modules (`run_passes`, `PASSES`,
                                 `AuditContext`)
  `repro_torch.analysis.lint`    AST lint rules over repo source
  `repro_torch.analysis.audit`   drivers: record a `LogdetPlan` / plan
                                 grid / plan artifact dir and run the
                                 passes
  `repro_torch.analysis.report`  `Finding` / `AuditReport` / allowlist

Entry points: ``plan.audit()`` and ``python -m repro_torch.analysis
--all [--device cpu]``.  The JAX package's ``exportable-custom-calls``
pass and ``SAFE_CUSTOM_CALLS`` have no torch meaning (the port's plan
artifact holds no program) and are not ported; ``parse_module`` is
replaced by `record`.

This package imports ``torch`` and never ``jax`` or ``repro``.
"""
from repro_torch.analysis.ir import (
    CollectiveStats, Instruction, Module, Recorder, Shape, collective_bytes,
    record, roofline,
)
from repro_torch.analysis.passes import (
    AuditContext, DEFAULT_PASS_IDS, PASSES, expected_engine_stages,
    expected_host_reads, register_pass, run_passes,
)
from repro_torch.analysis.report import (
    AuditReport, Finding, apply_allowlist, load_allowlist,
)
from repro_torch.analysis.lint import LINT_RULES, lint_paths, lint_source
from repro_torch.analysis.audit import (
    PlanAuditError, audit_aot_dir, audit_artifact, audit_grid, audit_plan,
    default_grid,
)

__all__ = [
    "Shape", "Instruction", "Module", "record", "Recorder",
    "collective_bytes", "CollectiveStats", "roofline",
    "AuditContext", "PASSES", "DEFAULT_PASS_IDS",
    "register_pass", "run_passes", "expected_engine_stages",
    "expected_host_reads",
    "Finding", "AuditReport", "load_allowlist", "apply_allowlist",
    "LINT_RULES", "lint_source", "lint_paths",
    "PlanAuditError", "audit_plan", "audit_grid", "default_grid",
    "audit_artifact", "audit_aot_dir", "DEFAULT_ALLOWLIST",
]

from pathlib import Path as _Path

# the committed waiver file next to this package; the CLI uses it unless
# --allowlist points elsewhere
DEFAULT_ALLOWLIST = _Path(__file__).with_name("allowlist.toml")
