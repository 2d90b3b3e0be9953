"""PGL010 — event-grammar exhaustiveness, consumer side.

PGL006 polices producers: a record family's enum fields only carry
declared values. This rule polices the other half of the contract: a
READER that dispatches on one of those enum fields — an
``if op == "accept": ... elif op == "token": ...`` chain, a membership
test, a ``match`` statement — must either handle every value the
grammar declares or carry an explicit default branch. Without this,
extending a grammar is a trap: add ``"evict"`` to the prefix-cache ops
and every fold/replay/summarize consumer that was written against the
two-value alphabet silently drops the new records — no crash, just
wrong totals (the deploy-ledger fold and the journal replay are
exactly such consumers; both are exhaustive today and are this rule's
true negatives).

Detection is deliberately conservative — silence over false alarms:

  * a *dispatch* is an if/elif chain (or ``match``) whose tests all
    compare the same subject against string literals, where the
    subject is ``rec.get(F)``/``rec[F]`` (or a variable assigned from
    one) for a field ``F`` in ``event_grammar.DISPATCH_FIELDS``;
  * chains handling fewer than two distinct values are filters, not
    dispatches, and are skipped;
  * the handled-value set binds to a grammar only when it is
    unambiguous: the enclosing function pins the ``ev`` (an
    ``x.get("ev") == "journal"`` comparison), or exactly one declared
    enum for ``F`` overlaps the handled values;
  * a chain with an ``else`` (or ``case _:``) is exhaustive by
    construction — the default branch is the extension point.

Once bound: handled ⊊ declared with no default → report the missing
values; a handled literal outside the declared alphabet → report it
(the consumer branches on a value no producer may emit — dead code or
a misspelling).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from progen_tpu_torch.analysis.core import Rule
from progen_tpu_torch.analysis.event_grammar import DISPATCH_FIELDS, enum_index

_ENUM_INDEX = enum_index()


def _subject_field(expr: ast.AST) -> Optional[str]:
    """The dispatch field when ``expr`` is ``X.get(F)``/``X[F]`` for
    F in DISPATCH_FIELDS, else None."""
    if isinstance(expr, ast.Call) and isinstance(
        expr.func, ast.Attribute
    ) and expr.func.attr == "get" and expr.args:
        key = expr.args[0]
        if isinstance(key, ast.Constant) and key.value in \
                DISPATCH_FIELDS:
            return key.value
    if isinstance(expr, ast.Subscript):
        sl = expr.slice
        if isinstance(sl, ast.Constant) and sl.value in DISPATCH_FIELDS:
            return sl.value
    return None


def _str_consts(node: ast.AST) -> Optional[Set[str]]:
    """The literal string set of a Constant / tuple-set-list of
    Constants, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.Set, ast.List)):
        out: Set[str] = set()
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            out.add(elt.value)
        return out
    return None


class GrammarConsumerRule(Rule):
    id = "PGL010"
    severity = "error"
    doc = ("event-grammar exhaustiveness, consumer side: readers "
           "dispatching on rec['op']/['status']/['state'] must handle "
           "every value the grammar declares or carry an explicit "
           "default branch — otherwise extending a grammar silently "
           "drops records in every stale consumer")

    def run(self):
        for node in ast.walk(self.ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(node)
        return self.findings

    # ----- per-function ---------------------------------------------------

    def _check_function(self, fn) -> None:
        field_vars = self._field_vars(fn)
        pinned_evs = self._pinned_evs(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.If) and not self._is_elif(node):
                self._check_chain(node, field_vars, pinned_evs)
            elif isinstance(node, ast.Match):
                self._check_match(node, field_vars, pinned_evs)

    def _is_elif(self, node: ast.If) -> bool:
        parent = self.ctx.parent(node)
        return isinstance(parent, ast.If) and parent.orelse == [node]

    def _field_vars(self, fn) -> Dict[str, str]:
        """var name -> dispatch field, for ``op = rec.get("op")``
        style local bindings."""
        out: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                f = _subject_field(node.value)
                if f is not None:
                    out[node.targets[0].id] = f
        return out

    def _pinned_evs(self, fn) -> Set[str]:
        """ev literals this function compares ``rec.get("ev")`` (or
        ``rec["ev"]``) against — used to disambiguate grammar binding."""
        out: Set[str] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Compare)
                    and len(node.ops) == 1):
                continue
            sides = (node.left, node.comparators[0])
            for a, b in (sides, sides[::-1]):
                if self._is_ev_access(a):
                    vals = _str_consts(b)
                    if vals:
                        out.update(vals)
        return out

    @staticmethod
    def _is_ev_access(expr: ast.AST) -> bool:
        if isinstance(expr, ast.Call) and isinstance(
            expr.func, ast.Attribute
        ) and expr.func.attr == "get" and expr.args:
            k = expr.args[0]
            return isinstance(k, ast.Constant) and k.value == "ev"
        if isinstance(expr, ast.Subscript):
            sl = expr.slice
            return isinstance(sl, ast.Constant) and sl.value == "ev"
        return False

    # ----- chain extraction -----------------------------------------------

    def _test_facts(
        self, test: ast.AST, field_vars: Dict[str, str]
    ) -> Optional[Tuple[str, Set[str]]]:
        """(field, values) when ``test`` compares a dispatch subject
        against string literals, else None."""
        if isinstance(test, ast.BoolOp) and isinstance(
            test.op, ast.Or
        ):
            field: Optional[str] = None
            values: Set[str] = set()
            for sub in test.values:
                facts = self._test_facts(sub, field_vars)
                if facts is None:
                    return None
                f, v = facts
                if field is None:
                    field = f
                elif field != f:
                    return None
                values.update(v)
            return (field, values) if field else None
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
            return None
        op = test.ops[0]
        sides = (test.left, test.comparators[0])
        for subj, lit in (sides, sides[::-1]):
            field = self._resolve_field(subj, field_vars)
            if field is None:
                continue
            vals = _str_consts(lit)
            if vals is None:
                return None
            if isinstance(op, ast.Eq) or (
                isinstance(op, ast.In) and subj is sides[0]
            ):
                return (field, vals)
            return None
        return None

    @staticmethod
    def _resolve_field(expr: ast.AST,
                       field_vars: Dict[str, str]) -> Optional[str]:
        f = _subject_field(expr)
        if f is not None:
            return f
        if isinstance(expr, ast.Name):
            return field_vars.get(expr.id)
        return None

    def _check_chain(self, head: ast.If, field_vars, pinned_evs) -> None:
        field: Optional[str] = None
        handled: Set[str] = set()
        cur: ast.stmt = head
        has_default = False
        while True:
            facts = self._test_facts(cur.test, field_vars)
            if facts is None:
                return  # mixed chain: not a pure enum dispatch
            f, vals = facts
            if field is None:
                field = f
            elif field != f:
                return
            handled.update(vals)
            if not cur.orelse:
                break
            if len(cur.orelse) == 1 and isinstance(
                cur.orelse[0], ast.If
            ):
                cur = cur.orelse[0]
                continue
            has_default = True
            break
        self._judge(head, field, handled, has_default, pinned_evs)

    def _check_match(self, node: ast.Match, field_vars,
                     pinned_evs) -> None:
        field = self._resolve_field(node.subject, field_vars)
        if field is None:
            return
        handled: Set[str] = set()
        has_default = False
        for case in node.cases:
            pat = case.pattern
            if isinstance(pat, ast.MatchValue) and isinstance(
                pat.value, ast.Constant
            ) and isinstance(pat.value.value, str):
                handled.add(pat.value.value)
            elif isinstance(pat, ast.MatchOr):
                for sub in pat.patterns:
                    if isinstance(sub, ast.MatchValue) and isinstance(
                        sub.value, ast.Constant
                    ) and isinstance(sub.value.value, str):
                        handled.add(sub.value.value)
                    else:
                        return
            elif isinstance(pat, ast.MatchAs) and pat.pattern is None:
                has_default = True
            else:
                return
        self._judge(node, field, handled, has_default, pinned_evs)

    # ----- binding + verdict ----------------------------------------------

    def _judge(self, node, field: Optional[str], handled: Set[str],
               has_default: bool, pinned_evs: Set[str]) -> None:
        if field is None or len(handled) < 2:
            return  # a one-value test is a filter, not a dispatch
        entry = self._bind(field, handled, pinned_evs)
        if entry is None:
            return
        unknown = handled - entry.values
        if unknown:
            self.report(
                node,
                f"dispatch on '{field}' handles "
                f"{'/'.join(sorted(unknown))} — not in the declared "
                f"'{entry.ev}' alphabet "
                f"({'/'.join(sorted(entry.values))}); no producer may "
                f"emit it, so this branch is dead code or a "
                f"misspelling (see analysis/event_grammar.py)",
            )
            return
        if has_default:
            return
        missing = entry.values - handled
        if missing:
            self.report(
                node,
                f"dispatch on '{field}' of the '{entry.ev}' grammar "
                f"handles {'/'.join(sorted(handled))} but not "
                f"{'/'.join(sorted(missing))}, and has no default "
                f"branch — records with the unhandled value(s) are "
                f"silently dropped; handle them or add an explicit "
                f"else (see analysis/event_grammar.py)",
            )

    def _bind(self, field: str, handled: Set[str], pinned_evs: Set[str]):
        entries = _ENUM_INDEX.get(field, [])
        if pinned_evs:
            pinned = [
                e for e in entries
                if e.ev in pinned_evs and (handled & e.values)
            ]
            if len(pinned) == 1:
                return pinned[0]
        overlapping = [e for e in entries if handled & e.values]
        if len(overlapping) == 1:
            return overlapping[0]
        supersets = [e for e in overlapping if handled <= e.values]
        if len(supersets) == 1:
            return supersets[0]
        return None
