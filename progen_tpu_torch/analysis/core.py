"""Shared linter core: findings, per-module context, suppressions. The
port's copy of the JAX package's ``analysis/core.py``, without its
traced-region index (``ModuleContext.in_traced_region``): that index
serves the JAX-trace rules PGL001-PGL005, and the port has no
``jax.jit``/``lax.scan`` region to find.

The rules in this package are AST visitors over one parsed module at a
time. Everything they need beyond the raw tree lives on
``ModuleContext``: parent links (ast has none), enclosing-function
qualnames for stable baseline keys, and the comment map that powers
inline ``# progen: ignore[RULE]`` suppressions.

Suppression syntax (two placements, same grammar):

    x = float(y)  # progen: ignore[PGL001] -- trace-time constant
    # progen: ignore[PGL002, PGL005]
    noisy_statement()

A bare ``# progen: ignore`` (no bracket) suppresses every rule on that
line; a comment that is the whole line applies to the line below it.
Suppressions are for one-off trace-time-only idioms; recurring accepted
findings belong in ``lint_baseline_torch.json`` where they carry a
reason.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set

SEVERITIES = ("error", "warning")

_IGNORE_RE = re.compile(
    r"#\s*progen:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_,\s]*)\])?"
)


@dataclass
class Finding:
    """One lint finding, locatable and baseline-keyable.

    ``func`` is the dotted enclosing-function qualname (``""`` at module
    level) — baseline entries match on (rule, path, func) so they
    survive unrelated line drift in the file.
    """

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    func: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def render(self) -> str:
        where = f" [{self.func}]" if self.func else ""
        return (
            f"{self.location()} {self.rule} {self.severity}: "
            f"{self.message}{where}"
        )

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "func": self.func,
            "message": self.message,
        }


def dotted_name(node: Optional[ast.AST]) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None. The syntactic
    spine every rule matches callables on — no imports are resolved, so
    rules match on suffixes (``lax.scan``) rather than absolute paths."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def name_suffix_in(name: Optional[str], suffixes) -> bool:
    """True when ``name`` equals a suffix or ends with ``.<suffix>`` —
    matches both ``jax.lax.scan`` and ``lax.scan`` against ``lax.scan``."""
    if not name:
        return False
    for suf in suffixes:
        if name == suf or name.endswith("." + suf):
            return True
    return False


def call_name(node: ast.AST) -> Optional[str]:
    return dotted_name(node.func) if isinstance(node, ast.Call) else None


_FUNCTION_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _comment_map(source: str) -> Dict[int, str]:
    """line -> comment text. tokenize sees what ast discards."""
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError):
        pass
    return comments


class ModuleContext:
    """Everything rules share about one parsed module."""

    def __init__(self, path, source: str, rel_to: Optional[Path] = None):
        self.abs_path = Path(path)
        try:
            self.path = str(self.abs_path.relative_to(rel_to or Path.cwd()))
        except ValueError:
            self.path = str(self.abs_path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self._qualnames: Dict[ast.AST, str] = {}
        self._suppressions = self._build_suppressions(source)

    # ----- suppressions ---------------------------------------------------

    def _build_suppressions(self, source: str) -> Dict[int, Set[str]]:
        supp: Dict[int, Set[str]] = {}
        for line_no, comment in _comment_map(source).items():
            m = _IGNORE_RE.search(comment)
            if not m:
                continue
            rules = m.group("rules")
            codes = (
                {r.strip().upper() for r in rules.split(",") if r.strip()}
                if rules is not None
                else {"*"}
            )
            src_line = (
                self.lines[line_no - 1] if line_no <= len(self.lines) else ""
            )
            target = line_no
            if src_line.lstrip().startswith("#"):
                # standalone comment guards the next CODE line (a
                # multi-line justification comment may sit in between)
                target = line_no + 1
                while target <= len(self.lines) and self.lines[
                    target - 1
                ].lstrip().startswith("#"):
                    target += 1
            supp.setdefault(target, set()).update(codes)
        return supp

    def is_suppressed(self, rule: str, line: int) -> bool:
        codes = self._suppressions.get(line, set())
        return "*" in codes or rule in codes

    # ----- structure helpers ----------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, _FUNCTION_NODES):
                return anc
        return None

    def qualname(self, node: ast.AST) -> str:
        """Dotted name of the function enclosing ``node`` ('' at module
        scope); lambdas render as ``<lambda>``."""
        if node in self._qualnames:
            return self._qualnames[node]
        parts: List[str] = []
        fn = (
            node
            if isinstance(node, _FUNCTION_NODES)
            else self.enclosing_function(node)
        )
        cur = fn
        while cur is not None:
            if isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            elif isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.ClassDef):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        qn = ".".join(reversed(parts))
        self._qualnames[node] = qn
        return qn


class ProjectRule:
    """Base class for whole-project rules: one instance lints one
    :class:`~progen_tpu_torch.analysis.project.ProjectContext` (cross-module
    indices built once by the runner, shared by every project rule).

    Module-scoped findings go through :meth:`report_at`, which honors
    inline ``# progen: ignore[...]`` suppressions exactly like
    :class:`Rule.report`; findings anchored in non-Python files (a CI
    workflow, a README) go through :meth:`report_text` — no inline
    suppression there, the baseline is the only grandfathering
    mechanism.
    """

    id = "PGL000"
    severity = "error"
    doc = ""

    def __init__(self, project):
        self.project = project
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        raise NotImplementedError

    def report_at(self, ctx: "ModuleContext", node: ast.AST,
                  message: str) -> None:
        line = getattr(node, "lineno", 0)
        if ctx.is_suppressed(self.id, line):
            return
        self.findings.append(
            Finding(
                rule=self.id,
                severity=self.severity,
                path=ctx.path,
                line=line,
                col=getattr(node, "col_offset", 0),
                message=message,
                func=ctx.qualname(node),
            )
        )

    def report_text(self, path: str, line: int, message: str) -> None:
        self.findings.append(
            Finding(
                rule=self.id,
                severity=self.severity,
                path=str(path),
                line=int(line),
                col=0,
                message=message,
            )
        )


@dataclass
class Rule(ast.NodeVisitor):
    """Base class: one rule instance lints one module. Subclasses set
    ``id``/``severity``/``doc`` and visit; ``report`` funnels findings
    through suppression checking."""

    ctx: ModuleContext
    findings: List[Finding] = field(default_factory=list)

    id = "PGL000"
    severity = "error"
    doc = ""

    def run(self) -> List[Finding]:
        self.visit(self.ctx.tree)
        return self.findings

    def report(self, node: ast.AST, message: str,
               severity: Optional[str] = None) -> None:
        line = getattr(node, "lineno", 0)
        if self.ctx.is_suppressed(self.id, line):
            return
        self.findings.append(
            Finding(
                rule=self.id,
                severity=severity or self.severity,
                path=self.ctx.path,
                line=line,
                col=getattr(node, "col_offset", 0),
                message=message,
                func=self.ctx.qualname(node),
            )
        )
