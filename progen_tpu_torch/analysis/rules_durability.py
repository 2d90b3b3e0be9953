"""PGL007 — durable-path write discipline (atomic publish / fsync).

The stack's exactly-once guarantees all bottom out in two file
idioms. State that must survive a kill (`meta.json`, `manifest.json`,
`*.pin`, `*.ack`) is published atomically: write a sibling ``.tmp``,
``os.fsync`` it, then ``os.replace`` onto the final name — a reader
sees the old complete file or the new complete file, never a torn one.
State that must survive a kill *per record* (``*.jsonl`` ledgers and
journals) is appended then ``flush`` + ``os.fsync``'d — the replay
contract ("a token the client saw is in the journal") is only as
strong as the weakest emit. Both idioms are hand-enforced conventions,
and the failure mode of forgetting one is silent: everything works
until the first power cut, and then a ledger admits a decision it
never durably made.

This rule finds the three ways the conventions decay, with
handle-level dataflow in the style of PGL002's key tracking:

  * a direct overwrite — ``open(durable, "w")`` / ``.write_text`` on a
    durable final path (not a ``.tmp`` sibling): a crash mid-write
    leaves a torn file where a complete one used to be;
  * a rename publish without fsync — the tmp file is written and
    ``os.replace``'d but never fsynced, so the rename can land in the
    directory before the data lands in the file (publishing garbage);
  * an fsync-less append — a handle opened ``"a"`` on a durable path
    whose writing method never calls ``os.fsync(handle.fileno())``
    (``flush`` alone moves bytes to the OS, not to disk).

What counts as *durable* is evidence-based, not blanket: a path
expression is durable when a string literal in it (including f-string
segments, ``Path /`` joins, ``with_name``/``with_suffix`` args and
resolved module-level constants) ends in ``.jsonl``/``.ack``/``.pin``
or names ``meta.json``/``manifest.json``, or when the variable/attr
naming it matches the pin/ack/journal/ledger/manifest vocabulary. A
``.tmp``/``.part`` marker anywhere in the expression wins and marks
the path as a scratch sibling (where direct writes are the POINT).
Telemetry streams that tolerate a torn tail by design (metrics,
spans) are baselined with reasons, not exempted here.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from progen_tpu_torch.analysis.core import Rule, call_name, dotted_name

_DURABLE_SUFFIXES = (".jsonl", ".ack", ".pin")
_DURABLE_BASENAMES = ("meta.json", "manifest.json")
_DURABLE_NAME_RE = re.compile(
    r"(^|_)(pin|ack|journal|ledger|manifest|meta)(_|$)|"
    r"(^|_)(pin|ack|journal|ledger|manifest)s?_(path|file|f)$"
)
_TMP_NAME_RE = re.compile(r"(^|_)(tmp|temp|scratch)(_|$)|tmp$")

_WRITE_MODES = ("w", "wb", "w+", "wb+", "x", "xb")
_APPEND_MODES = ("a", "ab", "a+", "ab+")


def _durable_text(s: str) -> bool:
    return s.endswith(_DURABLE_SUFFIXES) or any(
        s == b or s.endswith("/" + b) for b in _DURABLE_BASENAMES
    )


def _tmp_text(s: str) -> bool:
    return ".tmp" in s or s.endswith(".part")


def _walk_shallow(node: ast.AST) -> Iterator[ast.AST]:
    """Descendants of ``node``, not crossing into nested functions —
    the dataflow facts below are per-function."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            stack.extend(ast.iter_child_nodes(n))


def _base_name(node: ast.AST) -> Optional[str]:
    """A stable identifier for a handle/path expression: ``f`` for
    Name, ``self._f`` for a self attribute."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        d = dotted_name(node)
        if d and d.startswith("self."):
            return d
    return None


class DurabilityRule(Rule):
    id = "PGL007"
    severity = "error"
    doc = ("durable-path write discipline: ledger/journal/ack/manifest "
           "paths must be published atomically (tmp + os.fsync + "
           "os.replace) or appended with flush + os.fsync — direct "
           "overwrites, fsync-less renames and fsync-less appends all "
           "lose acknowledged state on a crash")

    def run(self):
        self._module_consts = self._collect_module_consts()
        for node in self.ctx.tree.body:
            if isinstance(node, ast.ClassDef):
                self._check_class(node)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self._check_function(node, {}, set())
        return self.findings

    # ----- classification -------------------------------------------------

    def _collect_module_consts(self) -> Dict[str, str]:
        consts: Dict[str, str] = {}
        for node in self.ctx.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Constant
            ) and isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        consts[t.id] = node.value.value
        return consts

    def _classify(self, expr: ast.AST,
                  cls_attrs: Dict[str, Optional[str]]) -> Optional[str]:
        """"tmp" | "durable" | None for a path expression. tmp wins:
        ``path.with_suffix(".jsonl.tmp")`` is the scratch sibling."""
        kinds = set()
        self._classify_into(expr, cls_attrs, kinds)
        if "tmp" in kinds:
            return "tmp"
        if "durable" in kinds:
            return "durable"
        return None

    def _classify_into(self, expr, cls_attrs, kinds: Set[str]) -> None:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            if _tmp_text(expr.value):
                kinds.add("tmp")
            if _durable_text(expr.value):
                kinds.add("durable")
        elif isinstance(expr, ast.Name):
            self._classify_ident(expr.id, kinds)
            const = self._module_consts.get(expr.id)
            if const is not None:
                if _tmp_text(const):
                    kinds.add("tmp")
                if _durable_text(const):
                    kinds.add("durable")
        elif isinstance(expr, ast.Attribute):
            base = _base_name(expr)
            if base and base.startswith("self."):
                attr = expr.attr
                known = cls_attrs.get(attr)
                if known is not None:
                    kinds.add(known)
                else:
                    self._classify_ident(attr, kinds)
            elif isinstance(expr, ast.Attribute):
                self._classify_ident(expr.attr, kinds)
        elif isinstance(expr, ast.BinOp):
            # Path "/" joins and string "+" concatenation both carry
            # the durable/tmp evidence of either side
            self._classify_into(expr.left, cls_attrs, kinds)
            self._classify_into(expr.right, cls_attrs, kinds)
        elif isinstance(expr, ast.JoinedStr):
            for part in expr.values:
                if isinstance(part, ast.Constant) and isinstance(
                    part.value, str
                ):
                    if _tmp_text(part.value):
                        kinds.add("tmp")
                    if _durable_text(part.value):
                        kinds.add("durable")
        elif isinstance(expr, ast.Call):
            cname = call_name(expr) or ""
            tail = cname.rsplit(".", 1)[-1]
            if tail in ("with_name", "with_suffix") and expr.args:
                self._classify_into(expr.args[0], cls_attrs, kinds)
                if isinstance(expr.func, ast.Attribute):
                    self._classify_into(
                        expr.func.value, cls_attrs, kinds
                    )
            elif tail in ("Path", "joinpath", "resolve", "absolute"):
                for a in expr.args:
                    self._classify_into(a, cls_attrs, kinds)
                if isinstance(expr.func, ast.Attribute):
                    self._classify_into(
                        expr.func.value, cls_attrs, kinds
                    )

    def _classify_ident(self, ident: str, kinds: Set[str]) -> None:
        low = ident.lower()
        if _TMP_NAME_RE.search(low):
            kinds.add("tmp")
        elif _DURABLE_NAME_RE.search(low):
            kinds.add("durable")

    # ----- per-class / per-function analysis ------------------------------

    def _check_class(self, cls: ast.ClassDef) -> None:
        cls_attrs: Dict[str, Optional[str]] = {}
        # a class that CALLS itself a journal/ledger has declared its
        # file durable, however generically the path attr is named
        if re.search(r"journal|ledger", cls.name, re.IGNORECASE):
            cls_attrs["path"] = "durable"
        durable_handles: Set[str] = set()
        init = next(
            (
                n for n in cls.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"
            ),
            None,
        )
        if init is not None:
            for node in _walk_shallow(init):
                if not isinstance(node, ast.Assign):
                    continue
                for t in node.targets:
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    open_info = self._open_call(node.value, cls_attrs)
                    if open_info is not None:
                        path_kind, mode = open_info
                        if (
                            path_kind == "durable"
                            and mode in _APPEND_MODES
                        ):
                            durable_handles.add(t.attr)
                        continue
                    kind = self._classify(node.value, cls_attrs)
                    if kind is None:
                        kinds: Set[str] = set()
                        self._classify_ident(t.attr, kinds)
                        kind = next(iter(kinds), None)
                    if kind is not None:
                        cls_attrs[t.attr] = kind
        for node in cls.body:
            if isinstance(node, ast.FunctionDef) and node.name != \
                    "__init__":
                self._check_function(node, cls_attrs, durable_handles)
            elif isinstance(node, ast.ClassDef):
                self._check_class(node)
        if init is not None:
            self._check_function(init, cls_attrs, set())

    def _open_call(self, expr, cls_attrs) -> Optional[Tuple[str, str]]:
        """(path_kind, mode) when ``expr`` opens a file, else None."""
        if not isinstance(expr, ast.Call):
            return None
        cname = call_name(expr) or ""
        tail = cname.rsplit(".", 1)[-1]
        if tail != "open":
            return None
        mode = "r"
        if cname == "open":
            if not expr.args:
                return None
            path_expr = expr.args[0]
            if len(expr.args) > 1 and isinstance(
                expr.args[1], ast.Constant
            ):
                mode = str(expr.args[1].value)
        else:
            path_expr = expr.func.value
            if expr.args and isinstance(expr.args[0], ast.Constant):
                mode = str(expr.args[0].value)
        for kw in expr.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = str(kw.value.value)
        kind = self._classify(path_expr, cls_attrs)
        return (kind or "", mode.replace("t", "").replace("+", "") +
                ("+" if "+" in mode else ""))

    def _check_function(self, fn, cls_attrs,
                        durable_handles: Set[str]) -> None:
        fsync_bases: Set[str] = set()
        any_fsync = False
        # identifiers written via write_text/write_bytes/open-"w" here
        written_bases: Set[str] = set()
        local_append: Dict[str, ast.AST] = {}  # handle -> open node
        handle_writes: Dict[str, ast.AST] = {}  # handle -> first write
        replaces: List[Tuple[ast.AST, ast.AST, ast.AST]] = []

        for node in _walk_shallow(fn):
            if isinstance(node, ast.Call):
                cname = call_name(node) or ""
                tail = cname.rsplit(".", 1)[-1]
                if tail == "fsync" and node.args:
                    any_fsync = True
                    arg = node.args[0]
                    if isinstance(arg, ast.Call) and isinstance(
                        arg.func, ast.Attribute
                    ) and arg.func.attr == "fileno":
                        base = _base_name(arg.func.value)
                    else:
                        base = _base_name(arg)
                    if base:
                        fsync_bases.add(base)
                elif tail in ("write_text", "write_bytes") and \
                        isinstance(node.func, ast.Attribute):
                    target = node.func.value
                    base = _base_name(target)
                    if base:
                        written_bases.add(base)
                    kind = self._classify(target, cls_attrs)
                    if kind == "durable":
                        self.report(
                            node,
                            f"direct .{tail} overwrite of a durable "
                            f"path — a crash mid-write leaves a torn "
                            f"file; write a .tmp sibling, os.fsync it, "
                            f"then os.replace onto the final name",
                        )
                elif tail == "replace" and cname.startswith(("os.",)) \
                        and len(node.args) >= 2:
                    replaces.append((node, node.args[0], node.args[1]))
                elif tail == "replace" and isinstance(
                    node.func, ast.Attribute
                ) and len(node.args) == 1 and not node.keywords:
                    # Path.replace(dst) — one arg; two args is
                    # str.replace(old, new), which is not a rename
                    replaces.append(
                        (node, node.func.value, node.args[0])
                    )
                elif tail == "rename" and cname.startswith("os.") and \
                        len(node.args) >= 2:
                    replaces.append((node, node.args[0], node.args[1]))
                elif tail in ("write", "writelines") and isinstance(
                    node.func, ast.Attribute
                ):
                    base = _base_name(node.func.value)
                    if base:
                        handle_writes.setdefault(base, node)
                elif tail == "dump" and cname.endswith("json.dump") \
                        and len(node.args) >= 2:
                    base = _base_name(node.args[1])
                    if base:
                        handle_writes.setdefault(base, node)
            if isinstance(node, (ast.Assign, ast.withitem)):
                value = (
                    node.value if isinstance(node, ast.Assign)
                    else node.context_expr
                )
                open_info = self._open_call(value, cls_attrs)
                if open_info is None:
                    continue
                kind, mode = open_info
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else ([node.optional_vars] if node.optional_vars
                          else [])
                )
                bases = [
                    b for b in (_base_name(t) for t in targets) if b
                ]
                if kind == "durable" and mode in _WRITE_MODES:
                    self.report(
                        value,
                        "open(durable_path, \"w\") overwrites the "
                        "published file in place — a crash mid-write "
                        "leaves a torn file where a complete one was; "
                        "write a .tmp sibling, os.fsync it, then "
                        "os.replace onto the final name",
                    )
                elif kind == "durable" and mode in _APPEND_MODES:
                    for b in bases:
                        local_append[b] = value
                if mode in _WRITE_MODES or mode in _APPEND_MODES:
                    for b in bases:
                        written_bases.add(b)
                    path_base = _base_name(
                        value.args[0] if call_name(value) == "open"
                        and value.args else value.func.value
                    )
                    if path_base:
                        written_bases.add(path_base)

        for handle, open_node in local_append.items():
            if handle in handle_writes and handle not in fsync_bases:
                self.report(
                    handle_writes[handle],
                    f"append to durable path via '{handle}' without "
                    f"os.fsync({handle}.fileno()) — flush() moves "
                    f"bytes to the OS, not to disk; an acknowledged "
                    f"record can vanish on power loss",
                )
        for attr_handle in durable_handles:
            base = "self." + attr_handle
            if base in handle_writes and base not in fsync_bases:
                self.report(
                    handle_writes[base],
                    f"append to durable handle '{base}' without "
                    f"os.fsync({base}.fileno()) in this method — "
                    f"flush() alone does not survive power loss, and "
                    f"the replay contract is only as strong as the "
                    f"weakest emit",
                )
        for rep_node, src, dst in replaces:
            if self._classify(dst, cls_attrs) != "durable":
                continue
            src_base = _base_name(src)
            if src_base and src_base in written_bases and not any_fsync:
                self.report(
                    rep_node,
                    "os.replace publishes a tmp file this function "
                    "wrote but never fsynced — the rename can reach "
                    "the directory before the data reaches the file, "
                    "publishing garbage after a crash; fsync the tmp "
                    "handle before replacing",
                )
