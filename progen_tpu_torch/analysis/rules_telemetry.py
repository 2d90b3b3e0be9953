"""PGL006 — telemetry hygiene, driven by the event-grammar registry.

Span hygiene only pays off when it is enforced (Dapper's lesson): a
span name that varies per call explodes the name cardinality the
summarize/trace tooling groups on; a hand-rolled ``{"ev": "B"}`` record
that never gets its ``E`` (an exception, an early return) corrupts the
open-span accounting the stall watchdog reports from. And a metric name
that fails the Prometheus grammar gets silently mangled by
``telemetry/prometheus.py``'s ``_name()`` at render time — the
dashboard query then matches nothing.

The per-``ev`` record grammars (which module may build each record
family, which fields are required, which values each enum field
allows) live in one declarative table: ``analysis/event_grammar.py``.
This rule is the PRODUCER side of that registry — it checks every
record-building site against the declaration. PGL010
(rules_grammar_consumers.py) is the consumer side: readers dispatching
on the same enum fields must handle every declared value. Extending a
grammar (a new op, a new record family) means editing the registry
once; both rules and the generated README reference section follow.

Beyond the registry, three bespoke checks survive here because they
are not per-``ev`` grammars:

  * ``span(...)`` / ``.span(...)`` names must be string literals (a
    bare name is allowed only when the enclosing function forwards its
    own parameter — the wrapper pattern ``spans.span`` itself uses);
  * string-literal metric names fed to the registry (``.inc``,
    ``.set_gauge``, ``.observe``, ``.set_gauges`` keys) must satisfy
    the Prometheus name rules the renderer enforces
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``);
  * an ``ev`` tag with no registered grammar must still be a clean
    greppable identifier, and must be a string literal when emitted.
"""

from __future__ import annotations

import ast
import re

from progen_tpu_torch.analysis.core import Rule, call_name
from progen_tpu_torch.analysis.event_grammar import (
    BY_EV,
    GRAMMARS,
    TRACE_KEY_MISSPELLINGS,
    EventGrammar,
)

_PROM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_REGISTRY_METHODS = ("inc", "set_gauge", "observe")

_DICT_SCOPE_GRAMMARS = tuple(g for g in GRAMMARS if g.scope == "dict")


def _str_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


class TelemetryHygieneRule(Rule):
    id = "PGL006"
    severity = "error"
    doc = ("event-grammar producer hygiene: literal span names, every "
           "ev record family built only by its registered owner with "
           "declared required fields and enum alphabets "
           "(analysis/event_grammar.py), Prometheus-legal metric names")

    def _enclosing_params(self, node) -> set:
        fn = self.ctx.enclosing_function(node)
        if fn is None:
            return set()
        a = fn.args
        return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        cname = call_name(node)
        tail = cname.rsplit(".", 1)[-1] if cname else ""
        if tail == "span" and node.args:
            self._check_span_name(node)
        if tail in ("emit", "log_event"):
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    self._check_event_dict(arg)
        if tail in _REGISTRY_METHODS and node.args:
            if _str_const(node.args[0]):
                self._check_prom_name(node.args[0], node.args[0].value)
        if tail == "set_gauges" and node.args:
            if isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    if _str_const(k):
                        self._check_prom_name(k, k.value)

    def visit_Dict(self, node: ast.Dict) -> None:
        # dict-scope grammars run on EVERY dict literal: samples/alerts/
        # scale/... records reach disk through the TSDB or an alert
        # file, not through emit() — an emit-only check would never see
        # them
        self.generic_visit(node)
        for k, v in zip(node.keys, node.values):
            if not (_str_const(k) and k.value == "ev" and _str_const(v)):
                continue
            grammar = BY_EV.get(v.value)
            if grammar is not None and grammar.scope == "dict":
                self._check_grammar(node, v, grammar)

    # ----- registry-driven record checks ----------------------------------

    def _check_grammar(self, d: ast.Dict, ev_node,
                       grammar: EventGrammar) -> None:
        if not grammar.owns(self.ctx.path):
            self.report(ev_node, grammar.owner_message)
        if grammar.required:
            present = {kk.value for kk in d.keys if _str_const(kk)}
            missing = [f for f in grammar.required if f not in present]
            if missing:
                self.report(
                    ev_node,
                    f"{grammar.ev} record missing field(s) "
                    f"{'/'.join(missing)} — {grammar.required_message}",
                )
        for enum in grammar.enums:
            for k, v in zip(d.keys, d.values):
                if not (_str_const(k) and k.value == enum.field):
                    continue
                if _str_const(v) and v.value not in enum.values:
                    self.report(
                        v,
                        f"{enum.what} is '{v.value}' — must be one of "
                        f"{'/'.join(enum.values)}: {enum.why}",
                    )
        if grammar.check_trace_key:
            for k in d.keys:
                if _str_const(k) and k.value in TRACE_KEY_MISSPELLINGS:
                    self.report(
                        k,
                        f"trace-context key '{k.value}' — the blessed "
                        f"spelling is 'trace_id' (stitch journey "
                        f"grouping and the kill-matrix contiguity "
                        f"assert grep exactly that key); a misspelled "
                        f"hop silently falls out of its journey",
                    )

    def _check_event_dict(self, d: ast.Dict) -> None:
        for k, v in zip(d.keys, d.values):
            if not (_str_const(k) and k.value == "ev"):
                continue
            if not _str_const(v):
                self.report(
                    v,
                    "event 'ev' tag must be a string literal so event "
                    "streams stay greppable",
                )
                continue
            grammar = BY_EV.get(v.value)
            if grammar is None:
                if not _PROM_NAME_RE.match(v.value):
                    self.report(
                        v,
                        f"event tag '{v.value}' is not a clean "
                        f"identifier ([a-zA-Z_][a-zA-Z0-9_]*) — "
                        f"downstream tooling keys on it",
                    )
            elif grammar.scope == "emit":
                # dict-scope grammars are handled by visit_Dict (which
                # also sees this literal) — checking both would double-
                # report
                self._check_grammar(d, v, grammar)

    # ----- bespoke checks (not per-ev grammars) ---------------------------

    def _check_span_name(self, node: ast.Call) -> None:
        name_arg = node.args[0]
        if _str_const(name_arg):
            return
        if isinstance(name_arg, ast.Name) and \
                name_arg.id in self._enclosing_params(node):
            return  # forwarding wrapper: span(name) inside def f(name)
        kind = (
            "an f-string" if isinstance(name_arg, ast.JoinedStr)
            else "a non-literal expression"
        )
        self.report(
            name_arg,
            f"span name is {kind} — span names must be string literals "
            f"so the trace/summarize tooling groups on a bounded, "
            f"greppable set; put varying data in span attrs instead",
        )

    def _check_prom_name(self, node, name: str) -> None:
        if not _PROM_NAME_RE.match(name):
            self.report(
                node,
                f"metric name '{name}' fails the Prometheus name rules "
                f"(telemetry/prometheus.py would mangle it at render "
                f"time and dashboard queries would miss): use "
                f"[a-zA-Z_:][a-zA-Z0-9_:]*",
            )
