"""Lint runner: file discovery, baseline filtering, reports. The port's
copy of the JAX package's ``analysis/runner.py``, with the rules that do
not depend on the backend: PGL006-PGL010. PGL001-PGL005 judge JAX trace
regions, PRNG keys and buffer donation, none of which the port has.

``lint_paths`` is the whole pipeline: parse each module once, run every
rule, then split findings into NEW vs BASELINED. The baseline
(``lint_baseline_torch.json``) grandfathers accepted
findings so the gate can be strict from day one without a big-bang
cleanup; entries match on ``(rule, path, func)`` — NOT line numbers —
so unrelated edits to a file don't resurrect them, and every entry
must carry a human ``reason`` (entries without one are rejected at
load, which is what keeps the baseline from becoming a dumping
ground).

Baseline entry shape::

    {"rule": "PGL007", "path": "progen_tpu_torch/x.py",
     "func": "Journal.emit", "reason": "flush-only by contract: ..."}

``path`` matches by suffix, so the baseline works from any invocation
directory.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from progen_tpu_torch.analysis.core import Finding, ModuleContext
from progen_tpu_torch.analysis.project import ProjectContext, default_text_files
from progen_tpu_torch.analysis.rules_chaos import ChaosDriftRule
from progen_tpu_torch.analysis.rules_durability import DurabilityRule
from progen_tpu_torch.analysis.rules_grammar_consumers import (
    GrammarConsumerRule,
)
from progen_tpu_torch.analysis.rules_locks import LockDisciplineRule
from progen_tpu_torch.analysis.rules_telemetry import TelemetryHygieneRule

RULES = (
    TelemetryHygieneRule,
    DurabilityRule,
    LockDisciplineRule,
    GrammarConsumerRule,
)

# whole-project rules: one instance lints the ProjectContext built
# over every discovered module (plus the README's port section), after
# the per-module rules have run
PROJECT_RULES = (ChaosDriftRule,)

RULE_DOCS: Dict[str, str] = {
    r.id: r.doc for r in RULES + PROJECT_RULES
}

_SKIP_DIR_NAMES = {
    "__pycache__", ".git", ".ruff_cache", "node_modules", "build",
    "dist", ".eggs",
    # intentionally-defective corpus for the lint tests — linted
    # explicitly by those tests, never by the package gate
    "lint_fixtures",
}


class BaselineError(ValueError):
    """Malformed baseline file — reported loudly, never skipped."""


def load_baseline(path) -> List[dict]:
    raw = json.loads(Path(path).read_text())
    entries = raw["findings"] if isinstance(raw, dict) else raw
    if not isinstance(entries, list):
        raise BaselineError(
            f"{path}: baseline must be a list of entries (or "
            f"{{'findings': [...]}})"
        )
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise BaselineError(f"{path}: entry {i} is not an object")
        for field in ("rule", "path", "reason"):
            if not isinstance(e.get(field), str) or not e[field].strip():
                raise BaselineError(
                    f"{path}: entry {i} missing non-empty '{field}' — "
                    f"every baselined finding needs a justification"
                )
    return entries


def _baseline_matches(entry: dict, finding: Finding) -> bool:
    if entry["rule"] != finding.rule:
        return False
    fpath = finding.path.replace("\\", "/")
    epath = entry["path"].replace("\\", "/")
    if not (fpath == epath or fpath.endswith("/" + epath)):
        return False
    if "func" in entry and entry["func"] != finding.func:
        return False
    return True


def discover_files(paths: Sequence) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIR_NAMES for part in f.parts):
                    files.append(f)
        elif p.suffix == ".py":
            files.append(p)
    return files


def _parse_module(path, rel_to: Optional[Path] = None):
    """(ctx, None) or (None, PGL000 finding) for a syntax error."""
    source = Path(path).read_text()
    try:
        ctx = ModuleContext(path, source, rel_to=rel_to)
    except SyntaxError as e:
        return None, Finding(
            rule="PGL000",
            severity="error",
            path=str(path),
            line=e.lineno or 0,
            col=e.offset or 0,
            message=f"syntax error: {e.msg}",
        )
    return ctx, None


def _run_module_rules(ctx: ModuleContext, rules) -> List[Finding]:
    findings: List[Finding] = []
    for rule_cls in rules:
        findings.extend(rule_cls(ctx).run())
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _run_project_rules(contexts, text_files,
                       project_rules) -> List[Finding]:
    if not project_rules or not contexts:
        return []
    project = ProjectContext.build(contexts, text_files=text_files)
    findings: List[Finding] = []
    for rule_cls in project_rules:
        findings.extend(rule_cls(project).run())
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_file(path, rel_to: Optional[Path] = None, rules=RULES,
              project_rules=PROJECT_RULES) -> List[Finding]:
    """All findings for one file — including project rules run over a
    single-file ProjectContext, so the fixture corpora exercise them
    standalone. Syntax errors surface as a single PGL000 error finding
    rather than crashing the run."""
    ctx, err = _parse_module(path, rel_to=rel_to)
    if err is not None:
        return [err]
    findings = _run_module_rules(ctx, rules)
    findings.extend(_run_project_rules([ctx], (), project_rules))
    return findings


def lint_paths(
    paths: Sequence,
    baseline: Optional[Sequence[dict]] = None,
    rel_to: Optional[Path] = None,
    rules=RULES,
    project_rules=PROJECT_RULES,
) -> Tuple[List[Finding], List[Finding]]:
    """(new_findings, baselined_findings) over every file under
    ``paths``. Modules are parsed ONCE; the per-module rules run on
    each, then the whole-project rules run on a ProjectContext built
    over all of them plus the README's port section.
    The exit-code contract is ``fail iff new_findings``."""
    all_findings: List[Finding] = []
    contexts: List[ModuleContext] = []
    for f in discover_files(paths):
        ctx, err = _parse_module(f, rel_to=rel_to)
        if err is not None:
            all_findings.append(err)
            continue
        contexts.append(ctx)
        all_findings.extend(_run_module_rules(ctx, rules))
    all_findings.extend(
        _run_project_rules(
            contexts, default_text_files(paths), project_rules
        )
    )
    if not baseline:
        return all_findings, []
    new, matched = [], []
    for finding in all_findings:
        if any(_baseline_matches(e, finding) for e in baseline):
            matched.append(finding)
        else:
            new.append(finding)
    return new, matched


def report_json(new: List[Finding], baselined: List[Finding]) -> dict:
    """The machine-readable report CI uploads as an artifact."""
    return {
        "tool": "progen-tpu-torch-lint",
        "rules": RULE_DOCS,
        "summary": {
            "new": len(new),
            "baselined": len(baselined),
            "by_rule": _by_rule(new),
        },
        "findings": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in baselined],
    }


def _by_rule(findings: List[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out
