"""ProjectContext: cross-module indices built once, shared by rules.
The port's copy of the JAX package's ``analysis/project.py``; only the
text files it reads differ (``default_text_files``).

The per-module rules (PGL006-008, PGL010) see one parsed file at a
time; the distributed-systems invariants are cross-module by nature: a
chaos kill-matrix in ``tests/test_torch_*.py`` or ``chip_smoke.py`` (or
a ``PROGEN_CHAOS`` example in the README's port section) names an
injection site that must actually be installed somewhere in
``progen_tpu_torch/``, and ``resilience/chaos.py``'s ``KNOWN_TARGETS``
registry must stay in lockstep with both. This
module parses every discovered file ONCE, builds the indices, and
hands them to every :class:`~progen_tpu_torch.analysis.core.ProjectRule`.

Indices built here:

  * ``sites`` — every chaos-injectable site actually installed in
    code: string-literal span names (``span("ckpt/save", ...)``),
    retry-site labels (``retry_call(..., label="data/read")`` /
    ``retryable("data/read")``), and direct injection points
    (``maybe_inject("serve/decode")`` / ``on_site`` / ``perturb``).
    These are exactly the names ``resilience/chaos.py`` keys rules on.
  * ``declared`` — the ``KNOWN_TARGETS = frozenset({...})`` literal
    (chaos.py's own registry), wherever one is defined in the linted
    set.
  * ``chaos_refs`` — every ``PROGEN_CHAOS`` target string referenced
    anywhere: chaos-spec literals (``"serve/decode:kill@3"``) and
    f-string prefixes (``f"serve/decode:kill@{n}"``) in Python source
    (string constants AND comments), plus the same spec tokens in the
    non-Python text that :func:`default_text_files` discovers next to
    the linted paths: the README's port section alone. The rest of the
    README, the other docs and the CI workflows describe the JAX
    package's surface, which is not the port's to judge.

The spec-token grammar mirrors ``chaos._parse``: ``target:spec`` where
the target contains at least one ``/`` (all real sites are
``area/site`` shaped) and the spec is ``kill[@N]``, ``fail@N``,
``spike@N``, ``nan@N``, or a probability — distinctive enough that
ordinary strings never match.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from progen_tpu_torch.analysis.core import (
    ModuleContext,
    _comment_map,
    call_name,
    name_suffix_in,
)

# a chaos spec token as it appears in env examples, test parametrize
# lists, CI workflow steps and docs: "ckpt/save:0.3", "data/read:kill",
# "serve/decode:kill@3", "train/loss:nan@2"
_SPEC_TOKEN_RE = re.compile(
    r"\b([a-z0-9_]+(?:/[a-z0-9_]+)+)"
    r":(?:kill(?:@\d+)?|fail@\d+|spike@\d+|nan@\d+|"
    r"(?:0?\.\d+|[01](?:\.0+)?))(?![\w@/])"
)
# an f-string's literal prefix, cut at the formatted hit index:
# f"serve/decode:kill@{n}" leaves "serve/decode:kill@"
_SPEC_PREFIX_RE = re.compile(
    r"([a-z0-9_]+(?:/[a-z0-9_]+)+):(?:kill|fail|spike|nan)@$"
)

_SITE_CALL_TAILS = ("maybe_inject", "on_site", "perturb")
_RETRY_CALLS = ("retry_call", "retryable")


@dataclass
class ChaosRef:
    """One referenced PROGEN_CHAOS target, with enough location to
    report on: ``ctx``/``node`` for Python sources (suppressible),
    bare path/line for text files."""

    target: str
    path: str
    line: int
    ctx: Optional[ModuleContext] = None
    node: Optional[ast.AST] = None


@dataclass
class ProjectContext:
    """Everything project rules share about the linted file set."""

    contexts: List[ModuleContext] = field(default_factory=list)
    # a path (the whole file) or (path, heading): the section under
    # that markdown heading alone
    text_files: List = field(default_factory=list)
    # site name -> [(path, line), ...] where it is installed
    sites: Dict[str, List[Tuple[str, int]]] = field(default_factory=dict)
    # KNOWN_TARGETS entries: target -> (ctx, node of the declaring str)
    declared: Dict[str, Tuple[ModuleContext, ast.AST]] = field(
        default_factory=dict
    )
    declaration: Optional[Tuple[ModuleContext, ast.AST]] = None
    chaos_refs: List[ChaosRef] = field(default_factory=list)

    @classmethod
    def build(cls, contexts: Sequence[ModuleContext],
              text_files: Sequence = ()) -> "ProjectContext":
        proj = cls(contexts=list(contexts), text_files=[
            (Path(p[0]), p[1]) if isinstance(p, tuple) else Path(p)
            for p in text_files])
        for ctx in proj.contexts:
            proj._index_module(ctx)
        for path in proj.text_files:
            proj._index_text_file(path)
        return proj

    # ----- per-module indexing --------------------------------------------

    def _add_site(self, name: str, ctx: ModuleContext, node) -> None:
        self.sites.setdefault(name, []).append(
            (ctx.path, getattr(node, "lineno", 0))
        )

    def _index_module(self, ctx: ModuleContext) -> None:
        # f-string literal parts are handled by _index_fstring (which
        # also applies the prefix grammar); don't double-index them as
        # standalone constants
        fstring_parts = {
            id(part)
            for node in ast.walk(ctx.tree)
            if isinstance(node, ast.JoinedStr)
            for part in node.values
        }
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                self._index_call(ctx, node)
            elif isinstance(node, ast.Assign):
                self._index_known_targets(ctx, node)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ) and id(node) not in fstring_parts:
                self._index_ref_string(ctx, node, node.value)
            elif isinstance(node, ast.JoinedStr):
                self._index_fstring(ctx, node)
        for line_no, comment in _comment_map(ctx.source).items():
            for m in _SPEC_TOKEN_RE.finditer(comment):
                self.chaos_refs.append(
                    ChaosRef(m.group(1), ctx.path, line_no, ctx=ctx)
                )

    def _index_call(self, ctx: ModuleContext, node: ast.Call) -> None:
        cname = call_name(node)
        # modules alias the helpers on import ("from spans import span
        # as _span") — strip the private prefix before matching
        tail = (cname.rsplit(".", 1)[-1] if cname else "").lstrip("_")
        if tail == "span" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ):
                self._add_site(arg.value, ctx, arg)
        elif tail in _SITE_CALL_TAILS and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(
                arg.value, str
            ):
                self._add_site(arg.value, ctx, arg)
        if name_suffix_in(cname, _RETRY_CALLS):
            for kw in node.keywords:
                if kw.arg == "label" and isinstance(
                    kw.value, ast.Constant
                ) and isinstance(kw.value.value, str):
                    self._add_site(kw.value.value, ctx, kw.value)
            if tail == "retryable" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    self._add_site(arg.value, ctx, arg)

    def _index_known_targets(self, ctx: ModuleContext,
                             node: ast.Assign) -> None:
        if not any(
            isinstance(t, ast.Name) and t.id == "KNOWN_TARGETS"
            for t in node.targets
        ):
            return
        value = node.value
        if isinstance(value, ast.Call) and call_name(value) in (
            "frozenset", "set"
        ) and value.args:
            value = value.args[0]
        if not isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            return
        self.declaration = (ctx, node)
        for elt in value.elts:
            if isinstance(elt, ast.Constant) and isinstance(
                elt.value, str
            ):
                self.declared.setdefault(elt.value, (ctx, elt))

    def _index_ref_string(self, ctx: ModuleContext, node,
                          text: str) -> None:
        for m in _SPEC_TOKEN_RE.finditer(text):
            self.chaos_refs.append(ChaosRef(
                m.group(1), ctx.path, getattr(node, "lineno", 0),
                ctx=ctx, node=node,
            ))
        m = _SPEC_PREFIX_RE.search(text)
        if m:
            self.chaos_refs.append(ChaosRef(
                m.group(1), ctx.path, getattr(node, "lineno", 0),
                ctx=ctx, node=node,
            ))

    def _index_fstring(self, ctx: ModuleContext,
                       node: ast.JoinedStr) -> None:
        for part in node.values:
            if isinstance(part, ast.Constant) and isinstance(
                part.value, str
            ):
                self._index_ref_string(ctx, node, part.value)

    # ----- text files (the README's port section) -------------------------

    def _index_text_file(self, entry) -> None:
        path, heading = entry if isinstance(entry, tuple) else (entry, None)
        try:
            text = path.read_text()
        except OSError:
            return
        try:
            rel = str(path.relative_to(Path.cwd()))
        except ValueError:
            rel = str(path)
        for i, line in section_lines(text, heading):
            for m in _SPEC_TOKEN_RE.finditer(line):
                self.chaos_refs.append(ChaosRef(m.group(1), rel, i))


# the README section that documents the port; the rest of the README
# documents the JAX package
PORT_README_HEADING = "## PyTorch/CUDA port"


def section_lines(text: str, heading: Optional[str] = None):
    """(line number, line) pairs of ``text``; with ``heading``, only the
    lines from that heading's line to the next heading of its level or
    above (none when the heading is absent)."""
    lines = list(enumerate(text.splitlines(), start=1))
    if heading is None:
        return lines
    level = len(heading) - len(heading.lstrip("#"))
    out: List[Tuple[int, str]] = []
    for i, line in lines:
        if out:
            mark = len(line) - len(line.lstrip("#"))
            if 0 < mark <= level and line[mark:mark + 1] == " ":
                break
            out.append((i, line))
        elif line.rstrip() == heading:
            out.append((i, line))
    return out


def default_text_files(paths: Sequence) -> List:
    """The non-Python text whose PROGEN_CHAOS references PGL009 checks:
    the port section of the README of the repo the linted paths belong
    to (found by walking up to a ``pyproject.toml``), as (path,
    heading). The JAX package's docs and CI workflows name its own
    sites, some of which the port has no counterpart for."""
    roots = set()
    for p in paths:
        cur = Path(p).resolve()
        if cur.is_file():
            cur = cur.parent
        while True:
            if (cur / "pyproject.toml").is_file():
                roots.add(cur)
                break
            if cur.parent == cur:
                break
            cur = cur.parent
    out: List = []
    for root in sorted(roots):
        readme = root / "README.md"
        if readme.is_file():
            out.append((readme, PORT_README_HEADING))
    return out
