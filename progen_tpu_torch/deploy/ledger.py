"""The deploy ledger: fsync'd ``ev:"deploy"`` records + replay. The
port's copy of the JAX package's ``deploy/ledger.py``.

The controller's ONLY durable state is ``deploy.jsonl`` — one JSON
line per decision, fsync'd before the call returns, so a SIGKILL at
any phase loses at most the action it had not yet recorded (and every
action is idempotent, so re-running it is safe). ``ev:"deploy"``
records are built only here (PGL006 owns the grammar), op from:

  * ``observed``  — a new complete checkpoint appeared (the record
    carries its digest and a TSDB latency snapshot as the live
    baseline);
  * ``canary``    — the canary replica was pinned to it;
  * ``probe``     — a probe-set scoring completed (pure measurement:
    token-weighted ppl, counts — the verdict lives in what follows);
  * ``promote``   — one non-canary replica was pinned to it (rolling:
    one record per replica);
  * ``rollback``  — the candidate was reverted; every replica re-pinned
    to the fleet checkpoint; the candidate is never retried;
  * ``converged`` — every replica acked the checkpoint: it IS the
    fleet checkpoint now.

``replay_state`` folds a ledger back into the controller's working
state: the fleet checkpoint is the last ``converged``, the candidate
is the last ``observed`` not yet converged or rolled back, completed
probes are never re-run, and per-replica ``promote`` records say who
was already told — a restarted controller re-pins nothing already
pinned and resumes mid-pipeline.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from progen_tpu_torch.telemetry.spans import get_telemetry
from progen_tpu_torch.telemetry.trace import iter_jsonl

DEPLOY_OPS = (
    "observed", "canary", "probe", "promote", "rollback", "converged"
)


class DeployLedger:
    """Append-only fsync'd JSONL writer; every record is mirrored to
    the telemetry sink so a tracker sees deploy decisions alongside
    everything else."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", encoding="utf-8")

    def append(self, op: str, ckpt: str, **fields) -> dict:
        if op not in DEPLOY_OPS:
            raise ValueError(f"unknown deploy op {op!r}")
        rec = {
            "ev": "deploy",
            "ts": float(fields.pop("ts", None) or time.time()),
            "op": op,
            "ckpt": str(ckpt),
            **fields,
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        get_telemetry().emit(rec)
        return rec

    def close(self) -> None:
        self._f.close()


def read_ledger(path) -> List[dict]:
    """All ``ev:"deploy"`` records, oldest first (torn tail skipped)."""
    p = Path(path)
    if not p.exists():
        return []
    return [r for r in iter_jsonl(p) if r.get("ev") == "deploy"]


@dataclasses.dataclass
class LedgerState:
    """The controller's working state, foldable from the ledger."""

    fleet: Optional[str] = None  # last converged checkpoint name
    fleet_digest: Optional[str] = None
    candidate: Optional[str] = None  # observed, not yet settled
    canaried: Dict[str, dict] = dataclasses.field(default_factory=dict)
    probes: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # ckpt -> {replica name: promote record} (who was already told)
    promoted: Dict[str, Dict[str, dict]] = dataclasses.field(
        default_factory=dict
    )
    failed: Set[str] = dataclasses.field(default_factory=set)
    observed: Dict[str, dict] = dataclasses.field(default_factory=dict)
    rollbacks: List[dict] = dataclasses.field(default_factory=list)


def fold(st: LedgerState, rec: dict) -> LedgerState:
    """Apply ONE ledger record to the state — shared by the startup
    replay and the controller's live appends, so a restarted controller
    reconstructs exactly the state a surviving one would hold."""
    op = rec.get("op")
    ckpt = str(rec.get("ckpt", ""))
    if op == "observed":
        st.observed[ckpt] = rec
        if ckpt not in st.failed and ckpt != st.fleet:
            st.candidate = ckpt
    elif op == "canary":
        st.canaried[ckpt] = rec
    elif op == "probe":
        st.probes[ckpt] = rec
    elif op == "promote":
        st.promoted.setdefault(ckpt, {})[
            str(rec.get("replica", ""))
        ] = rec
    elif op == "rollback":
        st.failed.add(ckpt)
        st.rollbacks.append(rec)
        if st.candidate == ckpt:
            st.candidate = None
    elif op == "converged":
        st.fleet = ckpt
        st.fleet_digest = rec.get("digest")
        if st.candidate == ckpt:
            st.candidate = None
    return st


def replay_state(records: Iterable[dict]) -> LedgerState:
    """Fold ledger records (oldest first) into a :class:`LedgerState`.
    Pure — the controller applies it, then re-verifies against the
    live pin/ack files before acting (the files, not the ledger, are
    the authority on what each replica is actually serving)."""
    st = LedgerState()
    for rec in records:
        fold(st, rec)
    return st
