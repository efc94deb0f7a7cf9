"""Repo-grounded AST lint over ``src/`` -- counterpart of
`repro.analysis.lint`, with the same four rule ids; the two rules that
name JAX calls target their PyTorch counterparts:

  ``unused-config-kwarg``   a function accepts a keyword with a default
                            and never reads it (the inert ``lookahead=``
                            flag class: accepted, documented, ignored)
  ``implicit-dtype``        ``torch.ones``/``torch.zeros``/``torch.full``/
                            ``torch.eye``/``torch.empty`` without an
                            explicit ``dtype=``: the tensor takes the
                            process default dtype, not the input's
                            (``*_like`` variants are fine)
  ``timing-no-block``       a function brackets work between two
                            ``time.perf_counter()``/``time.time()`` calls
                            with no sync in sight -- no
                            ``torch.cuda.synchronize``, no CUDA event's
                            ``synchronize``/``elapsed_time``, no
                            ``obs.span(..., sync=...)``: it times the
                            host's enqueue, not the card's work
  ``deprecated-route``      internal code passing one of the legacy exact
                            route strings (mc/mc_staged/mc_blocked/pmc/
                            pmc_blocked) as a ``method=`` — those are
                            one-release DeprecationWarning shims and must
                            not be load-bearing inside the library

Each rule reports `Finding`s (pass_id == rule id) with ``where`` set to
``path:line`` so the shared allowlist machinery (fnmatch on ``where``,
substring on ``code``) waives the residue with a recorded reason.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional

from repro_torch.analysis.report import AuditReport, Finding

__all__ = ["lint_source", "lint_paths", "lint_tree", "LINT_RULES"]

LINT_RULES = ("unused-config-kwarg", "implicit-dtype", "timing-no-block",
              "deprecated-route")

_LEGACY_ROUTES = {"mc", "mc_staged", "mc_blocked", "pmc", "pmc_blocked"}
# modules that legitimately *mention* the legacy strings: the definitions,
# the shim layer itself, and the plan dispatcher that resolves them
# (relative to the package, so the rule reads either package's tree)
_ROUTE_DEFINERS = ("core/engine.py", "core/configs.py", "core/api.py",
                   "core/plan.py")

_ARRAY_CTORS = {"ones", "zeros", "full", "eye", "empty"}


def _names_loaded(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)
            and isinstance(n.ctx, ast.Load)}


def _is_stub(fn: ast.FunctionDef) -> bool:
    """Protocol/ABC bodies: docstring + pass/.../raise only."""
    body = fn.body
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        body = body[1:]
    return all(isinstance(s, (ast.Pass, ast.Raise)) or
               (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant))
               for s in body)


def _finding(rule: str, path: str, node: ast.AST, message: str,
             code: str = "") -> Finding:
    return Finding(pass_id=rule, severity="error", message=message,
                   where=f"{path}:{getattr(node, 'lineno', 0)}",
                   context="lint", code=code)


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

def _rule_unused_config_kwarg(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if _is_stub(fn):
            continue
        # keyword-accepting params: positional-with-default + kw-only
        args = fn.args
        defaulted = args.args[len(args.args) - len(args.defaults):]
        candidates = list(defaulted) + list(args.kwonlyargs)
        if not candidates:
            continue
        loaded = _names_loaded(ast.Module(body=fn.body, type_ignores=[]))
        for a in candidates:
            name = a.arg
            if name.startswith("_") or name in ("self", "cls"):
                continue
            if name not in loaded:
                out.append(_finding(
                    "unused-config-kwarg", path, a,
                    f"{fn.name}() accepts {name}= and never reads it — "
                    "an inert knob callers believe is doing something",
                    code=f"{fn.name}({name}=...)"))
    return out


def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        base = f.value
        base_name = base.id if isinstance(base, ast.Name) else None
        return f"{base_name}.{f.attr}" if base_name else f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _has_dtype_arg(call: ast.Call) -> bool:
    """torch's constructors take dtype by keyword only."""
    return any(kw.arg == "dtype" for kw in call.keywords)


def _rule_implicit_dtype(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        name = _call_name(call)
        if name is None:
            continue
        mod, _, fn = name.rpartition(".")
        if mod != "torch" or fn not in _ARRAY_CTORS:
            continue
        if _has_dtype_arg(call):
            continue
        out.append(_finding(
            "implicit-dtype", path, call,
            f"torch.{fn}(...) without an explicit dtype= -- it takes the "
            "process default dtype, not the input's, and promotes or "
            "truncates everything it touches; pass dtype= (usually the "
            "input's)",
            code=f"torch.{fn}"))
    return out


_SYNC_ATTRS = ("synchronize", "elapsed_time")


def _is_sync(node: ast.AST) -> bool:
    """``torch.cuda.synchronize(...)``, an event's ``synchronize()`` /
    ``elapsed_time(...)``, or ``obs.span(..., sync=...)``."""
    if isinstance(node, ast.Attribute) and node.attr in _SYNC_ATTRS:
        return True
    if isinstance(node, ast.Name) and node.id in _SYNC_ATTRS:
        return True
    return (isinstance(node, ast.Call)
            and (_call_name(node) or "").rsplit(".", 1)[-1] == "span"
            and any(kw.arg == "sync" for kw in node.keywords))


_TIMER_CALLS = {"time.perf_counter", "time.time", "perf_counter",
                "time.monotonic", "monotonic"}


def _rule_timing_no_block(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        timers = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                  and _call_name(c) in _TIMER_CALLS]
        if len(timers) < 2:
            continue
        if not any(_is_sync(n) for n in ast.walk(fn)):
            out.append(_finding(
                "timing-no-block", path, timers[0],
                f"{fn.name}() walls-clocks between perf counters with no "
                "torch.cuda.synchronize, event sync or obs.span(sync=) -- "
                "it times the host's enqueue, not device work",
                code=fn.name))
    return out


def _rule_deprecated_route(tree: ast.AST, path: str) -> List[Finding]:
    if path.replace("\\", "/").endswith(_ROUTE_DEFINERS):
        return []
    out = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        for kw in call.keywords:
            if kw.arg == "method" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value in _LEGACY_ROUTES:
                out.append(_finding(
                    "deprecated-route", path, call,
                    f"internal call passes deprecated route string "
                    f"method={kw.value.value!r} — use method='exact' with "
                    "schedule=/update= (the shims are one release from "
                    "removal)", code=f"method={kw.value.value!r}"))
    return out


_RULE_FNS = {
    "unused-config-kwarg": _rule_unused_config_kwarg,
    "implicit-dtype": _rule_implicit_dtype,
    "timing-no-block": _rule_timing_no_block,
    "deprecated-route": _rule_deprecated_route,
}


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def lint_tree(tree: ast.AST, path: str,
              rules: Iterable[str] = LINT_RULES) -> List[Finding]:
    findings = []
    for rule in rules:
        findings.extend(_RULE_FNS[rule](tree, path))
    return findings


def lint_source(source: str, path: str = "<string>",
                rules: Iterable[str] = LINT_RULES) -> List[Finding]:
    return lint_tree(ast.parse(source), path, rules)


def lint_paths(paths: Iterable, root: Optional[Path] = None,
               rules: Iterable[str] = LINT_RULES) -> AuditReport:
    """Lint every ``.py`` file under ``paths`` -> `AuditReport`.

    ``where`` locations are recorded relative to ``root`` (default: the
    common parent) so allowlist globs stay machine-independent."""
    report = AuditReport(passes_run=list(rules), contexts=["lint"])
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            rel = str(f.relative_to(root)) if root else str(f)
            try:
                tree = ast.parse(f.read_text())
            except SyntaxError as exc:
                report.findings.append(Finding(
                    pass_id="lint", severity="error", context="lint",
                    message=f"unparseable source: {exc}", where=rel))
                continue
            report.findings.extend(lint_tree(tree, rel, rules))
    return report
