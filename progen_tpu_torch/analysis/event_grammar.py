"""The event-grammar registry: one declarative table for every ``ev``.
The port's copy of the JAX package's ``analysis/event_grammar.py``: the
port keeps the JAX record shapes, so the table is the same; owner paths
are suffixes and match either package, and the messages name the port's
directories.

The JAX package grew a fleet of JSONL event streams — spans, request
lifecycles, replay journals, routing decisions, deploy ledgers, alert
deliveries — each with a producer module that owns the record shape and
a set of consumers (summarize, stitch, the kill matrices, CI smokes)
that grep exactly that shape. The grammar used to live as ~600 lines of
hand-coded per-ev branches inside rules_telemetry.py, which meant the
producer rule (PGL006) was the ONLY thing that knew the alphabets: a
consumer could silently dispatch on half an enum and nothing noticed.

This module is now the single source of truth. Each :class:`EventGrammar`
declares, for one ``ev`` value:

  * ``owners`` — the module(s) allowed to build the record (path
    suffixes, or package dirs written ``"/pkg/"``);
  * ``scope`` — ``"emit"`` (checked on dicts passed to
    ``emit()``/``log_event()``) or ``"dict"`` (checked on EVERY dict
    literal, for records that reach disk through a writer other than
    the telemetry sink — TSDB samples, alert files);
  * ``required`` — fields that must be present on every record;
  * ``enums`` — fields whose literal values must come from a declared
    alphabet;
  * ``check_trace_key`` — whether misspellings of the one blessed
    trace-context key (``trace_id``) are policed on this record.

PGL006 (rules_telemetry.py) validates producers against this table;
PGL010 (rules_grammar_consumers.py) validates consumers — a reader
dispatching on ``rec["op"]``/``rec["status"]``/``rec["state"]`` must
handle every declared value or carry an explicit default branch.
``progen-tpu-torch-lint --registry-dump`` renders the table into the
README's generated port registry block, and ``--registry-check`` asserts
the committed docs match the dump.

Pure data + stdlib: importable from the jax-free lint CLI.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# the record fields consumers dispatch on — PGL010 recognizes a
# dispatch by these subscript/.get() keys, and binds the handled value
# set back to a grammar through the enum declarations below
DISPATCH_FIELDS = (
    "op", "status", "state", "ph", "kind", "action", "reason", "role",
)


@dataclass(frozen=True)
class EnumField:
    """One enum-constrained field: literal values must come from
    ``values``. ``what``/``why`` feed the finding message."""

    field: str
    values: Tuple[str, ...]
    what: str
    why: str


@dataclass(frozen=True)
class EventGrammar:
    """The declared shape of one ``ev`` record family."""

    ev: str
    owners: Tuple[str, ...]
    owner_message: str
    scope: str = "emit"  # "emit" | "dict"
    required: Tuple[str, ...] = ()
    required_message: str = ""
    enums: Tuple[EnumField, ...] = ()
    check_trace_key: bool = False

    def owns(self, path: str) -> bool:
        p = path.replace("\\", "/")
        for owner in self.owners:
            if owner.endswith("/"):
                if owner in p:
                    return True
            elif p.endswith(owner):
                return True
        return False

    def enum_for(self, field_name: str) -> "EnumField | None":
        for e in self.enums:
            if e.field == field_name:
                return e
        return None


def _g(*args, **kwargs) -> EventGrammar:
    return EventGrammar(*args, **kwargs)


_SPAN_BE_MESSAGE = (
    "raw B/E span record emitted directly — use the span() context "
    "manager, whose finally-block guarantees the matching E even on "
    "exceptions"
)

GRAMMARS: Tuple[EventGrammar, ...] = (
    _g(
        ev="B",
        owners=("telemetry/spans.py",),
        owner_message=_SPAN_BE_MESSAGE,
    ),
    _g(
        ev="E",
        owners=("telemetry/spans.py",),
        owner_message=_SPAN_BE_MESSAGE,
    ),
    _g(
        ev="req",
        owners=("serving/scheduler.py", "serving/router.py"),
        owner_message=(
            "raw async req record emitted outside serving/scheduler.py "
            "or serving/router.py — they own the request lifecycle "
            "grammar (every 'b' must get its 'e' on all exit paths); go "
            "through Scheduler/Router, not hand-rolled records"
        ),
        enums=(
            EnumField(
                "ph", ("b", "n", "e"), "req record 'ph'",
                "async trace events only use 'b' (begin), 'n' "
                "(instant), 'e' (end); anything else is dropped by the "
                "trace builder",
            ),
        ),
        check_trace_key=True,
    ),
    _g(
        ev="route",
        owners=("serving/router.py",),
        owner_message=(
            "raw route record emitted outside serving/router.py — the "
            "routing-decision grammar is what summarize's router "
            "section and the CI failover smoke key on; go through "
            "Router, not hand-rolled records"
        ),
        enums=(
            EnumField(
                "status",
                ("dispatched", "handoff", "shed", "replica_down"),
                "route record 'status'",
                "an unknown status is invisible to the router table in "
                "summarize and to the failover smoke",
            ),
        ),
        check_trace_key=True,
    ),
    _g(
        ev="journal",
        owners=("serving/journal.py",),
        owner_message=(
            "raw journal record emitted outside serving/journal.py — "
            "the replay journal's op grammar is the crash-recovery "
            "contract; go through RequestJournal, not hand-rolled "
            "records"
        ),
        enums=(
            EnumField(
                "op", ("accept", "token", "done"),
                "journal record 'op'",
                "replay_requests drops records it can't parse — an "
                "unknown op is silently lost work",
            ),
        ),
    ),
    _g(
        ev="reload",
        owners=("serving/reload.py",),
        owner_message=(
            "raw reload record emitted outside serving/reload.py — "
            "reload status records are what the zero-downtime smoke "
            "asserts on; go through WeightReloader, not hand-rolled "
            "records"
        ),
        enums=(
            EnumField(
                "status", ("staged", "committed", "rejected"),
                "reload record 'status'",
                "anything else reads as a torn reload to the "
                "zero-downtime tooling",
            ),
        ),
    ),
    _g(
        ev="score",
        owners=("/workloads/",),
        owner_message=(
            "raw score record emitted outside progen_tpu_torch/workloads/ — "
            "the batch-score journal's op grammar is the "
            "resume/progress contract the CI workloads smoke greps; go "
            "through ScoreJournal, not hand-rolled records"
        ),
        enums=(
            EnumField(
                "op", ("start", "resume", "batch", "skip", "done"),
                "score record 'op'",
                "an unknown op is invisible to the scoring progress "
                "tooling and the resume smoke",
            ),
        ),
    ),
    _g(
        ev="prefix_cache",
        owners=("serving/prefix_cache.py",),
        owner_message=(
            "raw prefix_cache record emitted outside "
            "serving/prefix_cache.py — cache reuse events are what the "
            "serving smoke's hit assertion and summarize key on; go "
            "through PrefixCache, not hand-rolled records"
        ),
        enums=(
            EnumField(
                "op", ("hit", "miss", "evict"),
                "prefix_cache record 'op'",
                "an unknown op is invisible to the cache-reuse "
                "accounting and the serving smoke",
            ),
        ),
    ),
    _g(
        ev="slo",
        owners=("telemetry/slo.py",),
        owner_message=(
            "raw slo record emitted outside telemetry/slo.py — "
            "objective-state transitions are the watchtower's "
            "judgment, keyed on by the SLO gate and summarize; go "
            "through SloWatch, not hand-rolled records"
        ),
        enums=(
            EnumField(
                "state", ("ok", "warn", "burning", "resolved"),
                "slo record 'state'",
                "the gate's exit-code contract and the transition "
                "grammar only know these states",
            ),
        ),
    ),
    _g(
        ev="flight",
        owners=("telemetry/flight.py",),
        owner_message=(
            "raw flight record emitted outside telemetry/flight.py — a "
            "'dumped' record is the recorder's receipt that a sealed, "
            "digest-valid black box reached disk; a hand-rolled one "
            "claims forensic evidence that was never written; go "
            "through FlightRecorder"
        ),
        enums=(
            EnumField(
                "op", ("armed", "dumped", "truncated"),
                "flight record 'op'",
                "the forensics smoke and query --trace grep exactly "
                "the armed/dumped/truncated op set",
            ),
        ),
    ),
    _g(
        ev="profile",
        owners=("telemetry/flight.py",),
        owner_message=(
            "raw profile record emitted outside telemetry/flight.py — "
            "the pin watcher's request/ack ledger is the proof a "
            "jax.profiler window actually ran (and was rate-limited); "
            "go through request_profile/ProfilePinWatcher"
        ),
        enums=(
            EnumField(
                "op", ("requested", "started", "stopped", "rejected"),
                "profile record 'op'",
                "the on-demand profiling smoke pairs "
                "requested/started/stopped and triages rejected — an "
                "unknown op is an invisible window",
            ),
        ),
    ),
    # ----- dict-scope grammars: records that reach disk through a
    # writer other than the telemetry sink (TSDB, alert files), so the
    # check runs on every dict literal, not just emit() args
    _g(
        ev="sample",
        owners=("telemetry/collector.py",),
        owner_message=(
            "raw collector sample record built outside "
            "telemetry/collector.py — the TSDB, the fleet aggregator "
            "and the ops console all parse one schema; build samples "
            "with make_sample()"
        ),
        scope="dict",
        enums=(
            EnumField(
                "role", ("replica", "router", "run"),
                "sample record 'role'",
                "fleet aggregation buckets liveness by exactly these "
                "roles",
            ),
        ),
    ),
    _g(
        ev="alert",
        owners=("telemetry/alerts.py",),
        owner_message=(
            "raw alert record built outside telemetry/alerts.py — "
            "alerts are edge-triggered state machines; a hand-rolled "
            "record bypasses the transition dedup and the field "
            "grammar the relay/CI smoke key on; go through AlertSink"
        ),
        scope="dict",
        required=("kind", "state", "source", "objective"),
        required_message=(
            "the alert relay and the fleet-metrics smoke key on "
            "kind/state/source/objective being present on every alert"
        ),
        enums=(
            EnumField(
                "kind", ("staleness", "slo_burn", "deploy_rollback"),
                "alert record 'kind'",
                "only staleness, slo_burn and deploy_rollback alerts "
                "exist; a new kind needs the grammar (and this rule) "
                "extended",
            ),
            EnumField(
                "state",
                ("stale", "fresh", "warn", "burning", "resolved",
                 "rolled_back"),
                "alert record 'state'",
                "the console colors and the smoke's quiet/burn asserts "
                "only know these states",
            ),
        ),
    ),
    _g(
        ev="scale",
        owners=("fleet/autoscaler.py",),
        owner_message=(
            "raw scale record built outside fleet/autoscaler.py — "
            "scaling decisions are the policy engine's judgment "
            "(hysteresis, cooldowns, edge-triggering), and the CI "
            "autoscale smoke keys on its records alone; go through "
            "Autoscaler.decide, not hand-rolled records"
        ),
        scope="dict",
        required=("action", "reason"),
        required_message=(
            "the autoscale smoke asserts an up AND a down were "
            "observed by exactly the action/reason fields"
        ),
        enums=(
            EnumField(
                "action", ("up", "down", "hold"),
                "scale record 'action'",
                "the smoke's up/down asserts and summarize only know "
                "these actions",
            ),
        ),
    ),
    _g(
        ev="frame_drop",
        owners=("fleet/transport.py",),
        owner_message=(
            "raw frame_drop record built outside fleet/transport.py — "
            "a drop record is the transport's proof a frame was "
            "validated and condemned; a hand-rolled one claims "
            "enforcement that never ran"
        ),
        scope="dict",
        enums=(
            EnumField(
                "reason",
                ("bad_magic", "bad_version", "bad_auth", "oversized",
                 "chaos", "idle_timeout"),
                "frame_drop record 'reason'",
                "drop triage greps exactly this reason set; an unknown "
                "reason is an invisible wire failure",
            ),
        ),
    ),
    _g(
        ev="notify",
        owners=("telemetry/alert_router.py",),
        owner_message=(
            "raw notify record built outside telemetry/alert_router.py "
            "— a notify record claims the dedup/silence/rate pipeline "
            "ran; a hand-rolled one forges a delivery the on-call "
            "never received; go through AlertRouter"
        ),
        scope="dict",
        enums=(
            EnumField(
                "status",
                ("sent", "failed", "silenced", "deduped", "escalated"),
                "notify record 'status'",
                "the console's delivery counts and the CI egress smoke "
                "classify by exactly the "
                "sent/failed/silenced/deduped/escalated alphabet",
            ),
        ),
    ),
    _g(
        ev="ship",
        owners=("telemetry/tsdb.py",),
        owner_message=(
            "raw ship record built outside telemetry/tsdb.py — a ship "
            "record is the shipper's proof a block's digest was "
            "verified into the archive manifest; a hand-rolled one "
            "claims history that was never tiered out"
        ),
        scope="dict",
        enums=(
            EnumField(
                "op", ("shipped", "skipped", "verify_failed"),
                "ship record 'op'",
                "retention triage greps exactly the "
                "shipped/skipped/verify_failed op set",
            ),
        ),
    ),
    _g(
        ev="deploy",
        owners=("/deploy/",),
        owner_message=(
            "raw deploy record built outside progen_tpu_torch/deploy/ — the "
            "deploy ledger is the controller's resume authority; a "
            "hand-rolled record forges a canary/promote/rollback "
            "decision the controller never made; go through "
            "DeployLedger"
        ),
        scope="dict",
        enums=(
            EnumField(
                "op",
                ("observed", "canary", "probe", "promote", "rollback",
                 "converged"),
                "deploy record 'op'",
                "the deployment smoke and the kill-matrix convergence "
                "asserts grep exactly the "
                "observed/canary/probe/promote/rollback/converged op "
                "set",
            ),
        ),
    ),
)

BY_EV: Dict[str, EventGrammar] = {g.ev: g for g in GRAMMARS}

# misspellings of the one blessed trace-context key: the stitcher's
# journey grouping greps records for exactly "trace_id", so a hop
# written under any of these never joins its journey
TRACE_KEY_MISSPELLINGS = (
    "trace", "traceid", "traceId", "trace_ctx", "trace_context",
    "span_id", "spanid",
)


@dataclass
class _EnumEntry:
    ev: str
    grammar: EventGrammar
    enum: EnumField
    values: frozenset = field(default_factory=frozenset)


def enum_index() -> Dict[str, List[_EnumEntry]]:
    """field name -> every (ev, enum) declaring it — PGL010's lookup
    table for binding a consumer's handled-value set to a grammar."""
    out: Dict[str, List[_EnumEntry]] = {}
    for g in GRAMMARS:
        for e in g.enums:
            out.setdefault(e.field, []).append(
                _EnumEntry(g.ev, g, e, frozenset(e.values))
            )
    return out


def render_grammar_markdown() -> str:
    """The generated "Event grammars" reference table — rendered into
    README.md by ``progen-tpu-torch-lint --registry-dump`` and checked
    against the committed docs by ``--registry-check``."""
    lines = [
        "| `ev` | producer | scope | required fields | enum fields |",
        "|---|---|---|---|---|",
    ]
    for g in GRAMMARS:
        owners = ", ".join(f"`{o}`" for o in g.owners)
        required = ", ".join(f"`{f}`" for f in g.required) or "—"
        enums = "; ".join(
            f"`{e.field}` ∈ {'/'.join(e.values)}" for e in g.enums
        ) or "—"
        scope = "all dicts" if g.scope == "dict" else "emit"
        lines.append(
            f"| `{g.ev}` | {owners} | {scope} | {required} | {enums} |"
        )
    return "\n".join(lines) + "\n"
