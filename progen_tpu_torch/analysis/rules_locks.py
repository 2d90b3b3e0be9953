"""PGL008 — lock discipline: guarded-attr consistency + handler safety.

Two defect classes, both of which this repo has shipped and debugged:

**Inconsistent guarding.** A class that mutates ``self._cursor`` under
``with self._lock:`` in one method and bare in another has decided the
attribute needs the lock — and then not taken it. The bare write is a
torn-update race that no CPU pytest run will ever catch (the GIL makes
single-opcode writes atomic, but compound updates and invariant pairs
are not). The rule is per-class: collect every instance attribute
written under a ``with self.<something-lock>:`` block in at least one
method, then flag writes of the same attribute outside any lock in
other methods (``__init__`` is exempt — no concurrent aliases exist
yet).

**Blocking work in handler contexts.** Emit taps, span-entry hooks,
``sys.excepthook`` and ``signal.signal`` handlers run re-entrantly
inside arbitrary code — including code that already holds the very
locks the handler wants. A flight-recorder deadlock was
exactly this: the tap fired mid-emit, the dump path did a blocking
``self._lock.acquire()``, and the thread waited on itself. (The fix —
``acquire(blocking=False)`` and shedding the dump — is the
true-negative fixture.) This half of the rule builds the set of
functions reachable from any handler registration in the module
(``EMIT_TAPS.append(...)``, ``*_HOOKS.append(...)``,
``sys.excepthook = ...``, ``signal.signal(sig, ...)``, following
``self.method()`` and bare same-module calls) and flags, inside that
set: blocking ``.acquire()`` on lock-ish receivers, and I/O performed
while lexically holding a lock (``time.sleep``, file writes, HTTP) —
the handler may already be inside the emit path it is about to wait
on.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from progen_tpu_torch.analysis.core import Rule, call_name, dotted_name

_HANDLER_LIST_SUFFIXES = ("_TAPS", "_HOOKS")
_HTTP_TAILS = ("urlopen", "get", "post", "put", "request", "connect",
               "sendall", "send")
_HTTP_PREFIXES = ("requests.", "urllib.", "http.", "socket.")


def _is_lockish(name: Optional[str]) -> bool:
    return bool(name) and "lock" in name.lower()


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(
        node.value, ast.Name
    ) and node.value.id == "self":
        return node.attr
    return None


class LockDisciplineRule(Rule):
    id = "PGL008"
    severity = "error"
    doc = ("lock discipline: attributes guarded by 'with self._lock' "
           "in one method must not be written bare in another, and "
           "emit-tap/excepthook/signal-handler code must never take a "
           "blocking lock or do I/O while holding one (the flight-dump "
           "deadlock class)")

    def run(self):
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.ClassDef):
                self._check_guarded_attrs(node)
        self._check_handlers()
        return self.findings

    # ----- part 1: guarded-attribute consistency --------------------------

    def _lock_with_ancestor(self, node: ast.AST,
                            within: ast.AST) -> Optional[str]:
        """Name of the lock-ish ``with`` context ``node`` sits in
        (lexically, inside ``within``), else None."""
        for anc in self.ctx.ancestors(node):
            if anc is within:
                return None
            if isinstance(anc, ast.With):
                for item in anc.items:
                    d = dotted_name(item.context_expr)
                    if d is None and isinstance(
                        item.context_expr, ast.Call
                    ):
                        d = call_name(item.context_expr)
                    if _is_lockish(d):
                        return d
        return None

    def _check_guarded_attrs(self, cls: ast.ClassDef) -> None:
        methods = [
            n for n in cls.body if isinstance(n, ast.FunctionDef)
        ]
        guarded: Dict[str, Tuple[str, str]] = {}  # attr -> (lock, meth)
        bare: List[Tuple[str, ast.AST, str]] = []
        for meth in methods:
            for node in ast.walk(meth):
                if isinstance(node, (ast.FunctionDef, ast.Lambda)) and \
                        node is not meth:
                    continue
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = list(node.targets)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        elts = t.elts
                    else:
                        elts = [t]
                    for elt in elts:
                        attr = _self_attr(elt)
                        if attr is None:
                            continue
                        lock = self._lock_with_ancestor(node, meth)
                        if lock is not None:
                            guarded.setdefault(
                                attr, (lock, meth.name)
                            )
                        elif meth.name not in (
                            "__init__", "__post_init__"
                        ):
                            bare.append((attr, node, meth.name))
        for attr, node, meth_name in bare:
            if attr not in guarded:
                continue
            lock, guard_meth = guarded[attr]
            self.report(
                node,
                f"self.{attr} is written under 'with {lock}:' in "
                f"{guard_meth}() but written bare here — the class "
                f"decided this attribute needs the lock; an unguarded "
                f"write is a torn-update race the GIL will not save "
                f"you from",
            )

    # ----- part 2: handler-context safety ---------------------------------

    def _handler_entry_names(self) -> Set[str]:
        entries: Set[str] = set()

        def add_target(fn_expr: ast.AST) -> None:
            if isinstance(fn_expr, ast.Name):
                entries.add(fn_expr.id)
            else:
                attr = _self_attr(fn_expr)
                if attr:
                    entries.add(attr)

        for node in ast.walk(self.ctx.tree):
            if isinstance(node, ast.Call):
                cname = call_name(node) or ""
                tail = cname.rsplit(".", 1)[-1]
                if tail == "append" and isinstance(
                    node.func, ast.Attribute
                ) and node.args:
                    recv = dotted_name(node.func.value) or ""
                    leaf = recv.rsplit(".", 1)[-1]
                    if leaf.endswith(_HANDLER_LIST_SUFFIXES):
                        add_target(node.args[0])
                elif tail == "signal" and cname.endswith(
                    "signal.signal"
                ) and len(node.args) >= 2:
                    add_target(node.args[1])
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if dotted_name(t) == "sys.excepthook":
                        add_target(node.value)
        return entries

    def _function_table(self) -> Dict[str, List[ast.FunctionDef]]:
        table: Dict[str, List[ast.FunctionDef]] = {}
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                table.setdefault(node.name, []).append(node)
        return table

    def _called_names(self, fn: ast.FunctionDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name):
                    out.add(node.func.id)
                else:
                    attr = _self_attr(node.func)
                    if attr:
                        out.add(attr)
        return out

    def _check_handlers(self) -> None:
        entries = self._handler_entry_names()
        if not entries:
            return
        table = self._function_table()
        reachable: Set[str] = set()
        frontier = [n for n in entries if n in table]
        while frontier:
            name = frontier.pop()
            if name in reachable:
                continue
            reachable.add(name)
            for fn in table[name]:
                for callee in self._called_names(fn):
                    if callee in table and callee not in reachable:
                        frontier.append(callee)
        for name in sorted(reachable):
            for fn in table[name]:
                self._check_handler_body(fn, entries)

    def _check_handler_body(self, fn: ast.FunctionDef,
                            entries: Set[str]) -> None:
        origin = (
            "is registered as an emit-tap/hook/excepthook/signal "
            "handler" if fn.name in entries
            else "is reachable from a registered "
            "tap/hook/excepthook/signal handler"
        )
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = call_name(node) or ""
            tail = cname.rsplit(".", 1)[-1]
            if tail == "acquire" and isinstance(
                node.func, ast.Attribute
            ):
                recv = dotted_name(node.func.value)
                if _is_lockish(recv) and self._acquire_blocks(node):
                    self.report(
                        node,
                        f"blocking {recv}.acquire() — {fn.name}() "
                        f"{origin}, so it can fire re-entrantly inside "
                        f"code already holding this lock and wait on "
                        f"itself (the flight-dump deadlock class); use "
                        f"acquire(blocking=False) and shed on "
                        f"contention",
                    )
            elif self._is_io_call(cname, tail, node):
                lock = self._lock_with_ancestor(node, fn)
                if lock is not None:
                    self.report(
                        node,
                        f"I/O ({cname or tail}) while holding "
                        f"'{lock}' — {fn.name}() {origin}; holding a "
                        f"lock across I/O in a re-entrant context "
                        f"stalls every thread that touches the lock "
                        f"for the duration of the I/O",
                    )

    @staticmethod
    def _acquire_blocks(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "blocking" and isinstance(
                kw.value, ast.Constant
            ) and kw.value.value is False:
                return False
            if kw.arg == "timeout" and isinstance(
                kw.value, ast.Constant
            ) and kw.value.value == 0:
                return False
        if node.args and isinstance(node.args[0], ast.Constant) and \
                node.args[0].value is False:
            return False
        return True

    def _is_io_call(self, cname: str, tail: str,
                    node: ast.Call) -> bool:
        if cname.endswith("time.sleep") or cname == "sleep":
            return True
        if tail == "open" or tail in ("write_text", "write_bytes"):
            return True
        if any(cname.startswith(p) for p in _HTTP_PREFIXES) and \
                tail in _HTTP_TAILS:
            return True
        return False
