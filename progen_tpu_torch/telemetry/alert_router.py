"""Alert routing: fingerprints, dedup, severity, silences, fan-out.

``AlertSink`` (``telemetry/alerts.py``) produces edge-triggered
``ev:"alert"`` records; this module decides who HEARS them. The
pipeline, per alert:

  1. **fingerprint** — ``kind:source:objective`` (stable across
     restarts and repeats; the identity operators silence and CI greps
     count by);
  2. **dedup** — an alert whose fingerprint is still in the state the
     router last routed is a repeat (collector restart, replayed
     stream), recorded once with ``status:"deduped"`` and delivered
     nowhere;
  3. **severity** — alert state → ``info``/``warning``/``critical``
     (overridable per state in the TOML), so routes can subscribe by
     floor instead of enumerating states;
  4. **per-route gates** — kind filter, ``min_severity`` floor, a
     per-fingerprint **silence window** (quiet period after each
     delivery on that route) and a per-route **rate limit**
     (deliveries/minute); a gated notification is recorded with
     ``status:"silenced"`` — suppression is itself evidence;
  5. **delivery** — ``webhook`` (HTTP POST with
     ``resilience/retry.py`` backoff, ``PROGEN_RETRY_*`` env knobs
     honored), ``stderr`` (one line for a terminal operator), or
     ``file`` (the ledger itself is the delivery).

**Escalation chains**: ``[route_X] escalate_to = "Y",
escalate_after_s = N`` — a warning/critical alert delivered through X
that is still in the same state after N seconds (nothing resolved or
changed it) re-fires through route Y, bypassing Y's kind/severity
gates, recorded with ``status:"escalated"`` and reason
``escalated_from:X``. The owning loop drives this by calling
``tick()``; pending escalations are rebuilt from the ledger on
restart (armed by the original ``sent`` record, disarmed by a later
state change or by the escalation's own record), so the re-fire
happens exactly once across router restarts. Chains do not cascade:
an escalated delivery does not arm Y's own ``escalate_to``.

Every routing decision — sent, failed, silenced, deduped, escalated —
lands as one ``ev:"notify"`` record in ``notifications.jsonl`` (the
ledger the console tails and CI asserts on). PGL006 enforces the
grammar: notify records are built only here, status from the
sent/failed/silenced/deduped/escalated alphabet. On construction the
router replays its own ledger to rebuild dedup + silence state, so a
restarted collector does not re-deliver what was already delivered.

The port's copy of the JAX package's ``telemetry/alert_router.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from progen_tpu_torch.resilience.retry import (
    is_transient,
    policy_from_env,
    retry_call,
)
from progen_tpu_torch.telemetry.spans import EventLog
from progen_tpu_torch.telemetry.trace import iter_jsonl

NOTIFY_STATUSES = ("sent", "failed", "silenced", "deduped", "escalated")
SEVERITIES = ("info", "warning", "critical")
ROUTE_SINKS = ("webhook", "file", "stderr")

# alert state -> default severity; TOML [alert_router] severity_<state>
# keys override per state
DEFAULT_SEVERITY = {
    "fresh": "info",
    "resolved": "info",
    "warn": "warning",
    "stale": "critical",
    "burning": "critical",
    "rolled_back": "critical",
}


def fingerprint(alert: dict) -> str:
    """Stable identity of an alert across repeats and restarts."""
    return ":".join((
        str(alert.get("kind", "")),
        str(alert.get("source", "")),
        str(alert.get("objective", "")),
    ))


def _severity_rank(sev: str) -> int:
    try:
        return SEVERITIES.index(sev)
    except ValueError:
        return 0


@dataclasses.dataclass
class RouteSpec:
    """One fan-out destination, parsed from a ``[route_<name>]``
    table. ``url`` is required only for the webhook sink."""

    name: str
    sink: str = "file"
    url: str = ""
    min_severity: str = "info"
    kinds: str = ""  # comma list; empty = all kinds
    silence_s: float = 0.0
    rate_limit_per_min: float = 0.0
    timeout_s: float = 5.0
    escalate_to: str = ""  # re-fire through this route when unacked
    escalate_after_s: float = 0.0

    def __post_init__(self):
        if self.sink not in ROUTE_SINKS:
            raise ValueError(
                f"route {self.name!r}: sink {self.sink!r} not in "
                f"{ROUTE_SINKS}"
            )
        if self.min_severity not in SEVERITIES:
            raise ValueError(
                f"route {self.name!r}: min_severity "
                f"{self.min_severity!r} not in {SEVERITIES}"
            )
        if self.sink == "webhook" and not self.url:
            raise ValueError(
                f"route {self.name!r}: webhook sink requires url"
            )
        if bool(self.escalate_to) != (self.escalate_after_s > 0):
            raise ValueError(
                f"route {self.name!r}: escalate_to and "
                "escalate_after_s must be set together"
            )
        if self.escalate_to == self.name:
            raise ValueError(
                f"route {self.name!r}: cannot escalate to itself"
            )

    def kind_set(self) -> Tuple[str, ...]:
        return tuple(
            k.strip() for k in self.kinds.split(",") if k.strip()
        )


def load_router_config(path) -> Tuple[Dict[str, str], List[RouteSpec]]:
    """``configs/serving/alert_router.toml`` → (severity overrides,
    routes). Unknown keys raise — a typo'd knob silently at its default
    is an operator who believes a silence is in force when it is not."""
    from progen_tpu_torch.config import load_toml_config

    raw = load_toml_config(str(path))
    severity = dict(DEFAULT_SEVERITY)
    top = raw.get("alert_router", {})
    if not isinstance(top, dict):
        raise ValueError(f"{path}: [alert_router] is not a table")
    for key, value in top.items():
        if not key.startswith("severity_"):
            raise ValueError(f"{path}: unknown alert_router key {key!r}")
        state = key[len("severity_"):]
        if state not in DEFAULT_SEVERITY:
            raise ValueError(
                f"{path}: severity override for unknown state {state!r}"
            )
        if value not in SEVERITIES:
            raise ValueError(
                f"{path}: severity_{state} = {value!r} not in "
                f"{SEVERITIES}"
            )
        severity[state] = value
    routes: List[RouteSpec] = []
    names = {f.name for f in dataclasses.fields(RouteSpec)} - {"name"}
    for table_name, table in raw.items():
        if table_name == "alert_router":
            continue
        if not table_name.startswith("route_"):
            raise ValueError(f"{path}: unknown table [{table_name}]")
        if not isinstance(table, dict):
            raise ValueError(f"{path}: [{table_name}] is not a table")
        unknown = set(table) - names
        if unknown:
            raise ValueError(
                f"{path}: unknown key(s) {sorted(unknown)} in "
                f"[{table_name}]"
            )
        routes.append(
            RouteSpec(name=table_name[len("route_"):], **table)
        )
    if not routes:
        raise ValueError(f"{path}: no [route_<name>] tables")
    return severity, routes


def _webhook_classify(exc: BaseException) -> bool:
    """Retry 5xx/429 and transport faults; a 4xx is a contract error
    that retrying cannot fix."""
    code = getattr(exc, "code", None)
    if code is not None:
        return int(code) >= 500 or int(code) == 429
    return is_transient(exc)


class AlertRouter:
    """See module doc. ``handle(alert)`` is wired as the
    :class:`AlertSink` relay; it must never raise into the scrape
    loop — delivery failures become ``status:"failed"`` records."""

    def __init__(
        self,
        ledger_path,
        routes: List[RouteSpec],
        severity: Optional[Dict[str, str]] = None,
        opener=None,
    ):
        self.ledger_path = Path(ledger_path)
        self.routes = list(routes)
        self._route_map = {r.name: r for r in self.routes}
        for r in self.routes:
            if r.escalate_to and r.escalate_to not in self._route_map:
                raise ValueError(
                    f"route {r.name!r}: escalate_to names unknown "
                    f"route {r.escalate_to!r}"
                )
        self.severity_map = dict(severity or DEFAULT_SEVERITY)
        self._opener = opener or urllib.request.urlopen
        self._policy = policy_from_env()
        self._policy = dataclasses.replace(
            self._policy, classify=_webhook_classify
        )
        # fingerprint -> last routed state (dedup across repeats)
        self._last_state: Dict[str, str] = {}
        # (route, fingerprint) -> last successful delivery ts (silence)
        self._last_sent: Dict[Tuple[str, str], float] = {}
        # route -> recent delivery timestamps (rate limit)
        self._sent_times: Dict[str, List[float]] = {}
        # (origin route, fingerprint) -> (deadline, alert) for armed
        # escalations; disarmed by a state change on the fingerprint
        # or by the escalation firing (tick)
        self._pending: Dict[Tuple[str, str], Tuple[float, dict]] = {}
        self.counts: Dict[str, int] = {s: 0 for s in NOTIFY_STATUSES}
        self._reload()
        self._ledger = EventLog(self.ledger_path)

    def close(self) -> None:
        self._ledger.close()

    # -- state reload -----------------------------------------------------

    def _reload(self) -> None:
        """Rebuild dedup/silence/rate state from the ledger so a router
        restart keeps the one-notification-per-edge promise."""
        if not self.ledger_path.exists():
            return
        for rec in iter_jsonl(self.ledger_path):
            if rec.get("ev") != "notify":
                continue
            fp = rec.get("fingerprint", "")
            status = rec.get("status", "")
            ts = float(rec.get("ts", 0.0))
            if status in self.counts:
                self.counts[status] += 1
            if status != "deduped":
                state = str(rec.get("state", ""))
                if self._last_state.get(fp) != state:
                    # a new edge acks everything armed on the old one
                    self._disarm(fp)
                self._last_state[fp] = state
            if status == "sent":
                route = str(rec.get("route", ""))
                self._last_sent[(route, fp)] = ts
                self._sent_times.setdefault(route, []).append(ts)
                spec = self._route_map.get(route)
                if spec is not None and spec.escalate_to:
                    sev = str(rec.get("severity", ""))
                    if _severity_rank(sev) >= _severity_rank("warning"):
                        # alert payload reconstructed from the notify
                        # record (not a new ev:"alert" — the original
                        # already fired; this is re-delivery material)
                        self._pending[(route, fp)] = (
                            ts + spec.escalate_after_s,
                            {
                                "ts": ts,
                                "kind": rec.get("kind", ""),
                                "state": rec.get("state", ""),
                                "source": rec.get("source", ""),
                                "objective": rec.get("objective", ""),
                            },
                        )
            reason = str(rec.get("reason", ""))
            if reason.startswith("escalated_from:"):
                # the escalation already fired (or terminally failed)
                origin = reason.split(":", 1)[1].split()[0]
                self._pending.pop((origin, fp), None)

    def _disarm(self, fp: str) -> None:
        for key in [k for k in self._pending if k[1] == fp]:
            del self._pending[key]

    # -- pipeline ---------------------------------------------------------

    def severity(self, state: str) -> str:
        return self.severity_map.get(str(state), "warning")

    def handle(self, alert: dict) -> List[dict]:
        """Route one alert record; returns the notify records written."""
        try:
            return self._handle(alert)
        except Exception as exc:  # the scrape loop must survive routing
            print(
                f"[alert-router] dropped alert: {exc}",
                file=sys.stderr,
            )
            return []

    def _handle(self, alert: dict) -> List[dict]:
        fp = fingerprint(alert)
        state = str(alert.get("state", ""))
        now = float(alert.get("ts", time.time()))
        sev = self.severity(state)
        if self._last_state.get(fp) == state:
            return [self._note(alert, fp, sev, now, route="",
                               status="deduped", reason="repeat")]
        self._last_state[fp] = state
        self._disarm(fp)  # the state edge acks any armed escalation
        out: List[dict] = []
        for route in self.routes:
            kinds = route.kind_set()
            if kinds and alert.get("kind") not in kinds:
                continue
            if _severity_rank(sev) < _severity_rank(route.min_severity):
                continue
            gate = self._gate(route, fp, now)
            if gate:
                out.append(self._note(alert, fp, sev, now,
                                      route=route.name,
                                      status="silenced", reason=gate))
                continue
            ok, detail = self._deliver(route, alert, fp, sev)
            status = "sent" if ok else "failed"
            if ok:
                self._last_sent[(route.name, fp)] = now
                self._sent_times.setdefault(route.name, []).append(now)
                if route.escalate_to and _severity_rank(sev) >= \
                        _severity_rank("warning"):
                    self._pending[(route.name, fp)] = (
                        now + route.escalate_after_s, dict(alert)
                    )
            out.append(self._note(alert, fp, sev, now,
                                  route=route.name, status=status,
                                  reason=detail))
        return out

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Fire due escalations. The owning loop (the collector CLI)
        calls this every iteration; it must never raise into it."""
        try:
            return self._tick(time.time() if now is None else float(now))
        except Exception as exc:
            print(
                f"[alert-router] escalation tick failed: {exc}",
                file=sys.stderr,
            )
            return []

    def _tick(self, now: float) -> List[dict]:
        out: List[dict] = []
        for (origin, fp), (deadline, alert) in list(self._pending.items()):
            if now < deadline:
                continue
            del self._pending[(origin, fp)]
            target = self._route_map.get(
                self._route_map[origin].escalate_to
            )
            if target is None:
                continue
            sev = self.severity(str(alert.get("state", "")))
            # escalation bypasses the target's kind/severity/silence
            # gates — it exists precisely because the normal path did
            # not get the alert acknowledged
            ok, detail = self._deliver(target, alert, fp, sev)
            reason = f"escalated_from:{origin}"
            if detail:
                reason += f" {detail}"
            out.append(self._note(
                alert, fp, sev, now, route=target.name,
                status="escalated" if ok else "failed", reason=reason,
            ))
        return out

    def _gate(self, route: RouteSpec, fp: str, now: float) -> str:
        """Route-level suppression reason, or '' to deliver."""
        if route.silence_s > 0:
            last = self._last_sent.get((route.name, fp))
            if last is not None and now - last < route.silence_s:
                return "silence_window"
        if route.rate_limit_per_min > 0:
            times = self._sent_times.setdefault(route.name, [])
            times[:] = [t for t in times if now - t < 60.0]
            if len(times) >= route.rate_limit_per_min:
                return "rate_limit"
        return ""

    # -- delivery ---------------------------------------------------------

    def _deliver(
        self, route: RouteSpec, alert: dict, fp: str, sev: str
    ) -> Tuple[bool, str]:
        if route.sink == "file":
            return True, ""  # the ledger write IS the delivery
        if route.sink == "stderr":
            print(
                f"[alert] {sev.upper()} {fp} -> "
                f"{alert.get('state')} (route {route.name})",
                file=sys.stderr,
            )
            return True, ""
        body = json.dumps(
            {
                "fingerprint": fp,
                "severity": sev,
                "route": route.name,
                "alert": alert,
            },
            separators=(",", ":"),
        ).encode("utf-8")

        def post():
            req = urllib.request.Request(
                route.url,
                data=body,
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with self._opener(req, timeout=route.timeout_s) as resp:
                status = int(getattr(resp, "status", 200))
                if status >= 300:
                    raise urllib.error.HTTPError(
                        route.url, status, "webhook rejected", None, None
                    )

        try:
            retry_call(post, label="alert/webhook", policy=self._policy)
            return True, ""
        except Exception as exc:
            return False, str(exc)

    # -- ledger -----------------------------------------------------------

    def _note(
        self,
        alert: dict,
        fp: str,
        sev: str,
        now: float,
        route: str,
        status: str,
        reason: str = "",
    ) -> dict:
        rec = {
            "ev": "notify",
            "ts": round(now, 3),
            "route": route,
            "status": status,
            "fingerprint": fp,
            "kind": alert.get("kind", ""),
            "state": alert.get("state", ""),
            "source": alert.get("source", ""),
            "objective": alert.get("objective", ""),
            "severity": sev,
        }
        if reason:
            rec["reason"] = reason
        self._ledger.emit(rec)
        self.counts[status] = self.counts.get(status, 0) + 1
        return rec


def read_notifications(path, limit: int = 0) -> List[dict]:
    """Tail helper for the console/CLI: the ledger's ``ev:"notify"``
    records, oldest first (last ``limit`` when set)."""
    p = Path(path)
    if not p.exists():
        return []
    recs = [r for r in iter_jsonl(p) if r.get("ev") == "notify"]
    return recs[-limit:] if limit else recs
