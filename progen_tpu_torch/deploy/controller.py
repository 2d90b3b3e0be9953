"""The deploy controller: one state machine, one action per tick. The
port's copy of the JAX package's ``deploy/controller.py``; its probe
restores the candidate on the controller's device (the card unless the
caller asks for the CPU) and scores through the port's batch scorer, one
full forward a batch through the kernels A1, L1 and L2.

Phases of a candidate checkpoint (all resumable via the ledger,
``deploy/ledger.py``):

  1. **observe** — the newest complete checkpoint that is not the
     fleet checkpoint and was never rolled back becomes the candidate;
     the ``observed`` record snapshots its digest and the fleet's live
     ttft p95 from the collector's TSDB (the latency baseline).
  2. **canary** (chaos site ``deploy/canary``) — write the candidate's
     name into the canary replica's ``reload.pin``; the replica's
     pinned-reload path (digest walk, tree-compat check, between-step
     ``commit_params``) answers through ``reload.pin.ack``. A rejected
     or timed-out pin rolls back; nothing else in the fleet has
     touched the new weights yet.
  3. **probe** (``deploy/probe``) — score the held-out probe FASTA
     with the batch scorer (``workloads/scoring.py``), resumable via
     its output-shard dedupe, into ``deploy_dir/probes/<ckpt>/``; the
     fleet checkpoint is probed the same way first, so the ppl
     baseline is owned and bit-reproducible, not scraped. Token-
     weighted ppl above ``max_ppl_regression_pct`` over baseline —
     or live ttft above ``max_ttft_regression_pct`` over the observed
     snapshot — rolls back.
  4. **promote** (``deploy/promote``) — pin the remaining replicas one
     at a time, each ``promote`` record appended after its pin write;
     the next replica is only pinned once the previous acked. The
     replica applies the swap between decode steps: no drain, no
     dropped requests, no recompiles.
  5. **converged** — every replica acked the candidate: it is the
     fleet checkpoint.

  * **rollback** (``deploy/rollback``) — any failure re-pins ALL
    replicas to the fleet checkpoint, appends a ``rollback`` record,
    and fires a ``deploy_rollback`` alert through the AlertSink
    (edge-dedup makes the webhook exactly-once even across controller
    restarts, which re-fire the alert from the replayed ledger).

A fresh ledger **adopts**: the newest verified checkpoint is declared
the fleet baseline and every replica pinned to it — start the
controller before publishing candidates, so no replica's newest-wins
watcher ever self-upgrades past the canary gate.

The ledger drives idempotence, the pin/ack files ground truth: a
restarted controller re-pins nothing already pinned (``Replica.pin``
is a no-op on equal content), never re-runs a completed probe, and
re-promotes only replicas whose ack is not yet on the candidate.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.deploy.ledger import (
    DeployLedger,
    LedgerState,
    fold,
    read_ledger,
    replay_state,
)
from progen_tpu_torch.telemetry.spans import span
from progen_tpu_torch.telemetry.trace import iter_jsonl

# the fleet-series key the ttft guard reads (collector.fleet_series)
TTFT_KEY = "ttft_s_p95_s"


@dataclasses.dataclass(frozen=True)
class DeployPolicy:
    """Deploy knobs; defaults are smoke-scale, not production."""

    interval_s: float = 2.0
    # canary replica name; "" = the first replica (sorted by name)
    canary: str = ""
    # candidate probe ppl may exceed baseline by at most this percent
    max_ppl_regression_pct: float = 1.0
    probe_batch_size: int = 8
    # conditioning tag prepended to probe sequences (FASTA grammar)
    probe_context: str = ""
    # live fleet ttft p95 may exceed the observed-time snapshot by at
    # most this percent while the canary serves (0 = guard off)
    max_ttft_regression_pct: float = 0.0
    # a canary/promote pin unanswered for this long rolls back — a
    # wedged replica must not stall the deploy pipeline forever
    ack_timeout_s: float = 120.0

    def __post_init__(self):
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.ack_timeout_s <= 0:
            raise ValueError("ack_timeout_s must be > 0")
        if self.max_ppl_regression_pct < 0:
            raise ValueError("max_ppl_regression_pct must be >= 0")
        if self.max_ttft_regression_pct < 0:
            raise ValueError("max_ttft_regression_pct must be >= 0")
        if self.probe_batch_size < 1:
            raise ValueError("probe_batch_size must be >= 1")


def load_deploy_policy(path) -> DeployPolicy:
    """Flat ``[deploy]`` TOML table -> policy; unknown keys raise (a
    typo'd knob silently at its default is a canary gate that is not
    in force)."""
    from progen_tpu_torch.config import load_toml_config

    raw = load_toml_config(str(path))
    table = raw.get("deploy", raw)
    if not isinstance(table, dict):
        raise ValueError(f"{path}: [deploy] is not a table")
    names = {f.name for f in dataclasses.fields(DeployPolicy)}
    unknown = set(table) - names
    if unknown:
        raise ValueError(
            f"{path}: unknown deploy key(s) {sorted(unknown)}"
        )
    return DeployPolicy(**table)


class Replica:
    """One replica's control seam: its ``reload.pin`` file (written
    here, honored by serve's ``--reload_pin`` poll) and the
    ``reload.pin.ack`` the replica answers through. The ack — not the
    ledger, not a prom scrape — is the authority on what a pin did."""

    def __init__(self, name: str, path):
        self.name = str(name)
        self.dir = Path(path)
        self.pin_path = self.dir / "reload.pin"
        self.ack_path = self.dir / "reload.pin.ack"

    def pinned(self) -> Optional[str]:
        try:
            content = self.pin_path.read_text().strip()
        except OSError:
            return None
        return content or None

    def pin(self, ckpt: str) -> bool:
        """Atomic pin write; a no-op (False) when already pinned to
        ``ckpt`` — the replay-idempotence seam."""
        if self.pinned() == ckpt:
            return False
        self.dir.mkdir(parents=True, exist_ok=True)
        tmp = self.pin_path.with_name(self.pin_path.name + ".tmp")
        with tmp.open("w") as f:
            f.write(ckpt + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.pin_path)
        return True

    def ack(self) -> Optional[dict]:
        try:
            return json.loads(self.ack_path.read_text())
        except (OSError, ValueError):
            return None

    def ack_for(self, ckpt: str) -> Optional[dict]:
        a = self.ack()
        return a if a is not None and a.get("pin") == ckpt else None

    def on(self, ckpt: str) -> bool:
        a = self.ack_for(ckpt)
        return bool(a and a.get("status") == "committed")

    def rejected(self, ckpt: str) -> Optional[str]:
        """The rejection reason when the replica rejected this pin."""
        a = self.ack_for(ckpt)
        if a and a.get("status") == "rejected":
            return str(a.get("reason", "rejected"))
        return None


def probe_stats(out_dir) -> dict:
    """Token-weighted perplexity over the scorer's output shards.
    Summation runs in sorted-id order over the deduped union, so the
    result is bit-identical no matter how many restarts (and fresh
    shards) the scoring took."""
    rows: Dict[str, dict] = {}
    pattern = os.path.join(str(out_dir), "scores-*.jsonl")
    for path in sorted(glob.glob(pattern)):
        for rec in iter_jsonl(path):
            if "id" in rec:
                rows[str(rec["id"])] = rec
    total_nll = 0.0
    total_tok = 0
    for rid in sorted(rows):
        rec = rows[rid]
        total_nll += float(rec["nll"]) * int(rec["n_tokens"])
        total_tok += int(rec["n_tokens"])
    ppl = math.exp(total_nll / total_tok) if total_tok else float("inf")
    return {"ppl": ppl, "n": len(rows), "tokens": total_tok}


class DeployController:
    """See module doc. ``tick()`` performs at most one action and
    returns its ledger op (or None when waiting/idle)."""

    def __init__(
        self,
        checkpoint_path,
        replicas: List[Replica],
        deploy_dir,
        policy: Optional[DeployPolicy] = None,
        *,
        probe_fasta: Optional[str] = None,
        reader=None,
        alerts=None,
        clock: Callable[[], float] = time.time,
        device="cuda",
    ):
        from progen_tpu_torch.checkpoint import get_checkpoint_fns

        if not replicas:
            raise ValueError("deploy controller needs >= 1 replica")
        self.checkpoint_path = str(checkpoint_path)
        self.replicas = sorted(replicas, key=lambda r: r.name)
        self.policy = policy or DeployPolicy()
        self.deploy_dir = Path(deploy_dir)
        self.probe_fasta = probe_fasta
        self.reader = reader
        self.alerts = alerts
        self._clock = clock
        # the probe's device: the card unless the caller asks for the CPU
        self.device = resolve_device(device)
        self._get_last = get_checkpoint_fns(self.checkpoint_path)[1]
        names = {r.name for r in self.replicas}
        if self.policy.canary and self.policy.canary not in names:
            raise ValueError(
                f"canary {self.policy.canary!r} not in replicas "
                f"{sorted(names)}"
            )
        self.canary = next(
            r for r in self.replicas
            if not self.policy.canary or r.name == self.policy.canary
        )
        self.state: LedgerState = replay_state(
            read_ledger(self.deploy_dir / "deploy.jsonl")
        )
        self.ledger = DeployLedger(self.deploy_dir / "deploy.jsonl")
        # replay re-fires rollback alerts: the sink's edge-dedup
        # suppresses any already delivered, so the webhook stays
        # exactly-once while a kill between ledger append and alert
        # emit still cannot lose the page
        if self.alerts is not None:
            for rec in self.state.rollbacks:
                self.alerts.deploy_rollback(
                    rec.get("ckpt", ""), rec.get("reason", "")
                )

    def close(self) -> None:
        self.ledger.close()

    # -- ledger -----------------------------------------------------------

    def _append(self, op: str, ckpt: str, **fields) -> dict:
        rec = self.ledger.append(
            op, ckpt, ts=self._clock(), **fields
        )
        fold(self.state, rec)
        return rec

    # -- inputs -----------------------------------------------------------

    def _newest_complete(self) -> Optional[str]:
        from progen_tpu_torch.checkpoint import _CKPT_NAME_RE, META_FILE

        root = Path(self.checkpoint_path)
        try:
            names = sorted(
                p.name for p in root.iterdir()
                if _CKPT_NAME_RE.fullmatch(p.name)
                and (p / META_FILE).exists()
            )
        except OSError:
            return None
        return names[-1] if names else None

    def _digest(self, ckpt: str) -> Optional[str]:
        from progen_tpu_torch.checkpoint import checkpoint_digest

        return checkpoint_digest(
            os.path.join(self.checkpoint_path, ckpt)
        )

    def _fleet_ttft(self) -> Optional[float]:
        """Latest fleet ttft p95 from the collector's TSDB, or None."""
        if self.reader is None:
            return None
        from progen_tpu_torch.telemetry.collector import fleet_series

        samples = [
            rec for rec in self.reader.read()
            if rec.get("ev") == "sample"
        ]
        series = fleet_series(samples)
        if not series:
            return None
        value = series[-1][1].get(TTFT_KEY)
        return None if value is None else float(value)

    # -- the tick ---------------------------------------------------------

    def tick(self) -> Optional[str]:
        """One action per call: observe/canary/probe/promote/rollback/
        converged, or None while waiting (acks) or idle."""
        if self.state.fleet is None:
            return self._adopt()
        newest = self._newest_complete()
        if (
            newest is not None
            and newest != self.state.fleet
            and newest not in self.state.failed
            and newest != self.state.candidate
            and newest > (self.state.candidate or "")
        ):
            return self._observe(newest)
        if self.state.candidate is None:
            self._enforce_fleet_pins()
            return None
        return self._advance(self.state.candidate)

    def _adopt(self) -> Optional[str]:
        """Fresh ledger: the newest verified checkpoint IS the fleet
        baseline — pin everyone to it before any candidate can be
        observed, so no replica's newest-wins watcher outruns the
        canary gate."""
        pkg = self._get_last.peek()
        if pkg is None:
            return None
        ckpt = Path(pkg.path).name
        for replica in self.replicas:
            replica.pin(ckpt)
        self._append("observed", ckpt, digest=self._digest(ckpt),
                     adopted=True)
        self._append("converged", ckpt, digest=self._digest(ckpt),
                     adopted=True)
        return "converged"

    def _observe(self, ckpt: str) -> str:
        fields = {"digest": self._digest(ckpt)}
        ttft = self._fleet_ttft()
        if ttft is not None:
            fields["baseline_ttft_p95_s"] = round(ttft, 6)
        self._append("observed", ckpt, **fields)
        return "observed"

    def _advance(self, cand: str) -> Optional[str]:
        now = self._clock()
        # -- canary ---------------------------------------------------
        if cand not in self.state.canaried:
            with span("deploy/canary", ckpt=cand):
                self.canary.pin(cand)
                self._append("canary", cand, replica=self.canary.name)
            return "canary"
        reason = self.canary.rejected(cand)
        if reason is not None:
            return self._rollback(cand, f"canary_rejected:{reason}")
        if not self.canary.on(cand):
            armed = float(self.state.canaried[cand].get("ts", now))
            if now - armed > self.policy.ack_timeout_s:
                return self._rollback(cand, "canary_timeout")
            return None  # waiting on the canary's ack
        # -- probe + verdict ------------------------------------------
        if self.probe_fasta is not None:
            baseline = self.state.probes.get(self.state.fleet)
            if baseline is None:
                stats = self._probe(self.state.fleet)
                self._append("probe", self.state.fleet, **stats)
                return "probe"
            if cand not in self.state.probes:
                try:
                    stats = self._probe(cand)
                except Exception as exc:
                    return self._rollback(
                        cand, f"probe_failed:{type(exc).__name__}"
                    )
                self._append("probe", cand, **stats)
                return "probe"
            verdict = self._verdict(cand)
            if verdict is not None:
                return self._rollback(cand, verdict)
        # -- promote (rolling, one replica per tick) ------------------
        told = self.state.promoted.get(cand, {})
        for replica in self.replicas:
            if replica is self.canary or replica.on(cand):
                continue
            reason = replica.rejected(cand)
            if reason is not None:
                return self._rollback(
                    cand, f"promote_rejected:{replica.name}:{reason}"
                )
            rec = told.get(replica.name)
            if rec is None:
                with span("deploy/promote", ckpt=cand,
                          replica=replica.name):
                    replica.pin(cand)
                    self._append("promote", cand, replica=replica.name)
                return "promote"
            if now - float(rec.get("ts", now)) > \
                    self.policy.ack_timeout_s:
                return self._rollback(
                    cand, f"promote_timeout:{replica.name}"
                )
            return None  # waiting on this replica's ack
        # -- converged ------------------------------------------------
        self._append("converged", cand, digest=self._digest(cand))
        return "converged"

    def _verdict(self, cand: str) -> Optional[str]:
        """Rollback reason, or None when the candidate passes."""
        base = self.state.probes[self.state.fleet]
        trial = self.state.probes[cand]
        limit = float(base["ppl"]) * (
            1.0 + self.policy.max_ppl_regression_pct / 100.0
        )
        if float(trial["ppl"]) > limit:
            return (
                f"ppl_regression:{float(trial['ppl']):.6g}"
                f">{limit:.6g}"
            )
        if self.policy.max_ttft_regression_pct > 0:
            snap = self.state.observed.get(cand, {}).get(
                "baseline_ttft_p95_s"
            )
            live = self._fleet_ttft()
            if snap is not None and live is not None:
                lim = float(snap) * (
                    1.0 + self.policy.max_ttft_regression_pct / 100.0
                )
                if live > lim:
                    return f"ttft_regression:{live:.6g}>{lim:.6g}"
        return None

    def _probe(self, ckpt: str) -> dict:
        """Score the probe FASTA on ``ckpt`` into its own output dir, with
        the checkpoint's parameters on the controller's device.
        Resumable: a controller killed mid-probe re-enters here and the
        scorer's shard dedupe skips everything durably scored."""
        from progen_tpu_torch.config import ProGenConfig
        from progen_tpu_torch.models.progen import ProGen
        from progen_tpu_torch.workloads import fasta_records, run_batch_score

        with span("deploy/probe", ckpt=ckpt):
            pkg = self._get_last.restore_params(at=ckpt, device=self.device)
            if pkg is None:
                raise RuntimeError(f"checkpoint {ckpt} not restorable")
            model = ProGen(ProGenConfig.from_dict(pkg.model_config),
                           device=self.device, seed=None)
            model.load_state_dict(pkg.state)
            del pkg  # the model holds its own copy of the parameters
            out_dir = str(self.deploy_dir / "probes" / ckpt)
            run_batch_score(
                model.eval(),
                fasta_records(
                    self.probe_fasta, self.policy.probe_context
                ),
                out_dir,
                batch_size=self.policy.probe_batch_size,
                logprobs=False, resume=True,
            )
            return probe_stats(out_dir)

    def _rollback(self, cand: str, reason: str) -> str:
        with span("deploy/rollback", ckpt=cand):
            for replica in self.replicas:
                replica.pin(self.state.fleet)
            self._append(
                "rollback", cand, to=self.state.fleet, reason=reason
            )
        if self.alerts is not None:
            self.alerts.deploy_rollback(cand, reason)
        return "rollback"

    def _enforce_fleet_pins(self) -> None:
        """Idle safety net: with no candidate in flight every replica
        belongs on the fleet checkpoint — re-assert the pins (no-op
        writes when already there), which also completes a rollback a
        SIGKILL interrupted between pin writes."""
        if self.state.fleet is None:
            return
        for replica in self.replicas:
            replica.pin(self.state.fleet)
