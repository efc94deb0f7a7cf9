"""Findings, audit reports, and the allowlist that waives them.

Counterpart of `repro.analysis.report`, pure Python, the same idents,
JSON and allowlist grammar.  Every checker pass (the recorded-op passes
in `repro_torch.analysis.passes`, the AST lint rules in
`repro_torch.analysis.lint`) reports `Finding`s; an `AuditReport` is the
machine-readable bundle a whole audit run produces -- the thing
``LogdetPlan.audit()`` returns and ``python -m repro_torch.analysis
--json`` writes.

Severities:
  ``error``    the invariant is broken — audits exit non-zero
  ``warning``  suspicious but not proof (promote with ``--strict``)
  ``info``     context / waived findings (never fails anything)

The allowlist (``src/repro_torch/analysis/allowlist.toml``) records *accepted*
findings with a one-line justification each.  A waived finding is kept in
the report (downgraded to ``info`` and flagged ``waived``) so the JSON
artifact still shows what was accepted and why.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Finding", "AuditReport", "SEVERITIES", "load_allowlist",
           "apply_allowlist"]

SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One checker result.

    ``pass_id``   which pass/rule produced it (e.g. "no-host-callback")
    ``severity``  "error" | "warning" | "info"
    ``message``   human-readable statement of the defect
    ``where``     location — "path.py:12", an instruction name, or ""
    ``context``   what was audited — "mesh|panel|lookahead fwd", "lint"
    ``code``      the offending fragment (instruction text / source line),
                  used by the allowlist's substring matcher
    ``waived``    True once an allowlist entry accepted it
    """
    pass_id: str
    severity: str
    message: str
    where: str = ""
    context: str = ""
    code: str = ""
    waived: bool = False

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in "
                             f"{SEVERITIES}")

    @property
    def ident(self) -> str:
        """Stable identity for baseline diffs: pass + context + where —
        message wording and volatile numbers excluded on purpose."""
        return f"{self.pass_id}::{self.context}::{_stable_where(self.where)}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ident"] = self.ident
        return d


def _stable_where(where: str) -> str:
    """Line numbers churn with unrelated edits; keep the file, drop the
    line, so a finding only counts as *new* when it moves files or the
    pass/context changes."""
    return re.sub(r":\d+$", "", where)


@dataclass
class AuditReport:
    """The machine-readable outcome of one audit run."""
    findings: List[Finding] = field(default_factory=list)
    passes_run: List[str] = field(default_factory=list)
    contexts: List[str] = field(default_factory=list)
    meta: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def extend(self, other: "AuditReport") -> "AuditReport":
        self.findings.extend(other.findings)
        for p in other.passes_run:
            if p not in self.passes_run:
                self.passes_run.append(p)
        for c in other.contexts:
            if c not in self.contexts:
                self.contexts.append(c)
        return self

    def to_json(self, indent: int = 2) -> str:
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "passes_run": self.passes_run,
            "contexts": self.contexts,
            "meta": self.meta,
            "ok": self.ok,
        }, indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "AuditReport":
        d = json.loads(text)
        findings = [Finding(**{k: v for k, v in f.items() if k != "ident"})
                    for f in d.get("findings", [])]
        return cls(findings=findings, passes_run=d.get("passes_run", []),
                   contexts=d.get("contexts", []), meta=d.get("meta", {}))

    def summary(self) -> str:
        lines = [f"audit: {len(self.findings)} finding(s) over "
                 f"{len(self.contexts)} context(s), "
                 f"{len(self.passes_run)} pass(es)"]
        for f in self.findings:
            tag = f"[{f.severity}{'/waived' if f.waived else ''}]"
            loc = f" @ {f.where}" if f.where else ""
            ctx = f" ({f.context})" if f.context else ""
            lines.append(f"  {tag:17s} {f.pass_id}{ctx}{loc}: {f.message}")
        if not self.findings:
            lines.append("  clean")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# allowlist -- TOML array-of-tables, parsed with the JAX package's subset
# reader: the grammar is [[pass-id]] tables of string keys, stricter than
# tomllib (which would take other value types and multi-line strings)
# --------------------------------------------------------------------------

_TABLE_RE = re.compile(r"^\[\[([\w\-./]+)\]\]\s*$")
_KV_RE = re.compile(r'^([\w\-]+)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


def load_allowlist(path) -> Dict[str, List[dict]]:
    """Parse the allowlist file -> {pass_id: [entry, ...]}.

    Grammar (a strict TOML subset): ``[[<pass-id>]]`` array-of-table
    headers, each followed by ``key = "string"`` pairs.  Every entry must
    carry a ``reason``; matchers are ``where`` (fnmatch glob against the
    finding's location), ``context`` (fnmatch) and ``code`` (substring of
    the offending fragment).  Unparseable lines raise — a typo must not
    silently widen the waiver."""
    entries: Dict[str, List[dict]] = {}
    current: Optional[dict] = None
    try:
        text = open(path).read()
    except FileNotFoundError:
        return entries
    for ln, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        tm = _TABLE_RE.match(line)
        if tm:
            current = {}
            entries.setdefault(tm.group(1), []).append(current)
            continue
        kv = _KV_RE.match(line)
        if kv and current is not None:
            current[kv.group(1)] = kv.group(2).replace('\\"', '"')
            continue
        raise ValueError(
            f"{path}:{ln}: unparseable allowlist line {line!r} — entries "
            'are [[pass-id]] headers and key = "value" string pairs')
    for pid, group in entries.items():
        for e in group:
            if not e.get("reason"):
                raise ValueError(
                    f"{path}: allowlist entry for {pid!r} has no reason= "
                    "— every waiver must say why")
    return entries


def _entry_matches(entry: dict, f: Finding) -> bool:
    if "where" in entry and not fnmatch.fnmatch(f.where, entry["where"]):
        return False
    if "context" in entry and not fnmatch.fnmatch(f.context,
                                                  entry["context"]):
        return False
    if "code" in entry and entry["code"] not in f.code:
        return False
    return True


def apply_allowlist(report: AuditReport,
                    allowlist: Dict[str, List[dict]]) -> AuditReport:
    """Downgrade allowlisted findings to waived ``info`` entries."""
    out = []
    for f in report.findings:
        for entry in allowlist.get(f.pass_id, []):
            if _entry_matches(entry, f):
                f = dataclasses.replace(
                    f, severity="info", waived=True,
                    message=f"{f.message} [waived: {entry['reason']}]")
                break
        out.append(f)
    report.findings = out
    return report
