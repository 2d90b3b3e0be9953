"""Alert sink: transition records → an alerts JSONL (webhook file).

Alerts are the collector's *actionable* output — everything else it
writes is evidence. Three kinds, all edge-triggered (a condition that
holds for an hour produces exactly two lines: onset and recovery):

  * ``kind:"staleness"`` — a source's ``up`` bit flipped: its
    exposition file stopped refreshing (process dead or wedged) or
    came back;
  * ``kind:"slo_burn"`` — the fleet-SLO watchtower crossed a state
    edge (``warn``/``burning``/``resolved``), forwarded from
    ``SloWatch`` so the paging decision rides the *merged* fleet
    series, not any single replica's file;
  * ``kind:"deploy_rollback"`` — the deploy controller reverted a
    canary checkpoint (state ``rolled_back``, objective = the
    checkpoint name), so a bad rollout pages through the same
    pipeline as a burning SLO.

The sink file uses the journal's write discipline (append, one line,
flush) so a tail -f or a webhook relay can follow it live; ``ev:
"alert"`` records are built only here (PGL006 enforces the grammar:
kind/state alphabets, source/objective always present).

Edge-triggering survives restarts: the sink persists its last-known
state per alert identity (``kind|source|objective``) in a small JSON
file beside ``alerts.jsonl`` and reloads it on start, so a restarted
collector neither re-fires an alert for a condition it already
reported (``suppressed`` counts those) nor misses the recovery edge of
a condition that flipped while it was down. An optional ``relay``
callable (the alert router) receives every record that survives the
dedup.

The port's copy of the JAX package's ``telemetry/alerts.py``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from progen_tpu_torch.telemetry.spans import EventLog

ALERT_KINDS = ("staleness", "slo_burn", "deploy_rollback")
ALERT_STATES = (
    "stale", "fresh", "warn", "burning", "resolved", "rolled_back"
)


class AlertSink:
    """Append-only ``ev:"alert"`` writer over an :class:`EventLog`;
    keeps the most recent records in memory for the console and the
    last state per alert identity on disk for restart dedup."""

    def __init__(
        self,
        path,
        keep: int = 64,
        state_path=None,
        relay: Optional[Callable[[dict], object]] = None,
    ):
        self._log = EventLog(path)
        self.path = self._log.path
        self.keep = int(keep)
        self.recent: List[dict] = []
        self.relay = relay
        self.suppressed = 0
        self.state_path = (
            Path(state_path) if state_path
            else self.path.with_suffix(".state.json")
        )
        try:
            self._states: Dict[str, str] = json.loads(
                self.state_path.read_text()
            )
        except (OSError, ValueError):
            self._states = {}

    def close(self) -> None:
        self._log.close()

    @staticmethod
    def _key(kind: str, source: str, objective: str = "") -> str:
        return f"{kind}|{source}|{objective}"

    def last_state(
        self, kind: str, source: str, objective: str = ""
    ) -> Optional[str]:
        return self._states.get(self._key(kind, source, objective))

    def last_states(self, kind: str) -> Dict[str, str]:
        """``{source-or-objective: state}`` for one alert kind — what
        the collector seeds its transition detectors from on start."""
        out: Dict[str, str] = {}
        for key, state in self._states.items():
            k, source, objective = key.split("|", 2)
            if k == kind:
                out[objective if k == "slo_burn" else source] = state
        return out

    def _save_states(self) -> None:
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._states, sort_keys=True))
        os.replace(tmp, self.state_path)

    def _emit(self, rec: dict) -> Optional[dict]:
        key = self._key(rec["kind"], rec["source"], rec["objective"])
        if self._states.get(key) == rec["state"]:
            # identical state already on record (typically: a restart
            # replayed the same transition) — the alert fired once
            self.suppressed += 1
            return None
        self._states[key] = rec["state"]
        self._save_states()
        self._log.emit(rec)
        self.recent.append(rec)
        del self.recent[: -self.keep]
        if self.relay is not None:
            self.relay(rec)
        return rec

    def staleness(
        self,
        source: str,
        up: bool,
        age_s: float,
        now: Optional[float] = None,
    ) -> dict:
        return self._emit({
            "ev": "alert",
            "ts": float(time.time() if now is None else now),
            "kind": "staleness",
            "state": "fresh" if up else "stale",
            "source": str(source),
            "objective": "",
            "age_s": round(float(age_s), 3),
        })

    def deploy_rollback(
        self, ckpt: str, reason: str, now: Optional[float] = None
    ) -> Optional[dict]:
        """The deploy controller reverted ``ckpt`` — exactly-once per
        checkpoint across controller restarts (the identity is
        ``deploy_rollback|deploy|<ckpt>`` and a replayed rollback hits
        the same-state dedup)."""
        return self._emit({
            "ev": "alert",
            "ts": float(time.time() if now is None else now),
            "kind": "deploy_rollback",
            "state": "rolled_back",
            "source": "deploy",
            "objective": str(ckpt),
            "reason": str(reason),
        })

    def slo_transition(
        self, slo_rec: dict, exemplars: Optional[dict] = None
    ) -> dict:
        """Forward one ``ev:"slo"`` transition record (SloWatch output)
        as an alert; the original burn numbers ride along, and when the
        caller has fleet trace exemplars (the collector does) the worst
        trace ids land in the payload — the page names the requests
        behind the burn, not just the quantile."""
        rec = {
            "ev": "alert",
            "ts": float(slo_rec.get("ts", time.time())),
            "kind": "slo_burn",
            "state": str(slo_rec.get("state", "warn")),
            "source": "fleet",
            "objective": str(slo_rec.get("objective", "")),
            "burn_short": slo_rec.get("burn_short"),
            "burn_long": slo_rec.get("burn_long"),
            "value": slo_rec.get("value"),
        }
        if exemplars:
            rec["exemplars"] = {
                fam: list(exs) for fam, exs in exemplars.items() if exs
            }
        return self._emit(rec)
