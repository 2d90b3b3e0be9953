"""TSDB-driven fleet autoscaler: merged metrics in, scale decisions out.

MegaScale's observability lesson (PAPERS.md) applied to control: fleet
decisions should be driven by the aggregated metrics stream, not by
whatever process happens to notice pressure first. The fleet collector
already maintains exactly that stream — per-source ``ev:"sample"``
records in a ring TSDB, folded by ``fleet_series`` into one series
with reset-safe counter sums, max/sum gauges and merged latency
quantiles — and this module is its first control-plane consumer.

Each tick the :class:`Autoscaler` reads the TSDB (``TsdbReader`` —
read-only, never races the collector), takes the LATEST fleet point,
and runs pure policy math (:func:`evaluate_policy`, device-free and
clock-free, unit-tested directly):

  * scale UP when queue pressure (``queue_depth_sum`` across router +
    replicas) or a latency objective (fleet ``ttft_s`` p95 / ``itl_s``
    p99) is above its high-water mark;
  * scale DOWN when the queue is below its low-water mark and every
    latency objective is comfortable — the gap between the two
    watermarks IS the hysteresis band (a fleet sitting between them
    holds, so the scaler cannot flap on a boundary load);
  * a breach must SUSTAIN for ``up_sustain``/``down_sustain``
    consecutive ticks before acting (one bursty scrape is noise);
  * after any action the matching cooldown (``up_cooldown_s`` /
    ``down_cooldown_s``) gates the next one — spawn cost and drain
    cost are asymmetric, so the two directions get separate clocks;
  * ``min_replicas``/``max_replicas`` bound the target; no data, or a
    latest point older than ``stale_after_s``, always holds (scaling
    on a dead collector's last opinion would be flying blind).

Decisions land as ``{"ev": "scale", "action": up|down|hold, ...}``
records (grammar owned HERE, linted by PGL006), edge-triggered: every
up/down is recorded, holds only when their reason changes — a 2s tick
must not bury the trace in steady-state holds.

Execution is the caller's job (cli/router.py): the router owns its
``--spawn``/``--fleet_dir`` fleet, spawns scale-ups with ``--replay``
and drains scale-downs before reaping. Chaos site
``autoscaler/decide`` fires at the top of each decide tick.

Policy knobs load from a flat ``[autoscaler]`` TOML table
(``configs/serving/autoscaler.toml`` is the shipped example).

The port's copy of the JAX package's ``fleet/autoscaler.py``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from progen_tpu_torch.resilience.chaos import maybe_inject

# the scale-record action alphabet (PGL006-enforced)
ACTION_UP = "up"
ACTION_DOWN = "down"
ACTION_HOLD = "hold"

# hold/action reasons, bounded so scripts and summarize can grep
REASON_NO_DATA = "no_data"
REASON_STALE_DATA = "stale_data"
REASON_QUEUE_HIGH = "queue_high"
REASON_TTFT_HIGH = "ttft_p95_high"
REASON_ITL_HIGH = "itl_p99_high"
REASON_QUEUE_LOW = "queue_low"
REASON_SUSTAIN = "sustaining"
REASON_COOLDOWN = "cooldown"
REASON_AT_MAX = "at_max_replicas"
REASON_AT_MIN = "at_min_replicas"
REASON_STEADY = "steady"


@dataclasses.dataclass(frozen=True)
class ScalingPolicy:
    """Autoscaler knobs; defaults are smoke-scale, not production."""

    min_replicas: int = 1
    max_replicas: int = 4
    # queue watermarks: total queued across router + replicas
    # (queue_depth_sum on the fleet series). The gap is the hysteresis
    # band — high must stay strictly above low.
    queue_high: float = 8.0
    queue_low: float = 1.0
    # latency high-water marks; 0 disables the signal
    ttft_p95_high_s: float = 0.0
    itl_p99_high_s: float = 0.0
    # consecutive breaching ticks required before acting
    up_sustain: int = 2
    down_sustain: int = 3
    # seconds after the last action before the next one may fire
    up_cooldown_s: float = 20.0
    down_cooldown_s: float = 60.0
    # a latest fleet point older than this holds (collector dead/stuck)
    stale_after_s: float = 15.0
    # the caller's decide cadence (cli/router.py reads it)
    interval_s: float = 2.0
    # max queued/in-flight requests the router migrates onto a replica
    # that just turned HEALTHY (serving/router.py rebalance bound)
    rebalance_max: int = 4

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if self.queue_high <= self.queue_low:
            raise ValueError(
                f"queue_high ({self.queue_high}) must exceed queue_low "
                f"({self.queue_low}) — the gap is the hysteresis band"
            )
        if self.up_sustain < 1 or self.down_sustain < 1:
            raise ValueError("sustain counts must be >= 1")


def load_policy(path) -> ScalingPolicy:
    """Flat ``[autoscaler]`` TOML table -> policy; unknown keys raise
    (a typo'd knob silently at its default is a misconfigured fleet)."""
    from progen_tpu_torch.config import load_toml_config

    raw = load_toml_config(str(path))
    table = raw.get("autoscaler", raw)
    if not isinstance(table, dict):
        raise ValueError(f"{path}: [autoscaler] is not a table")
    names = {f.name for f in dataclasses.fields(ScalingPolicy)}
    unknown = set(table) - names
    if unknown:
        raise ValueError(
            f"{path}: unknown autoscaler key(s) {sorted(unknown)}"
        )
    return ScalingPolicy(**table)


@dataclasses.dataclass
class Decision:
    """One decide-tick verdict. ``target`` is the replica count the
    fleet should converge to (== current on hold)."""

    action: str
    target: int
    reason: str
    current: int
    signals: Dict[str, float] = dataclasses.field(default_factory=dict)


def extract_signals(vals: Dict[str, float]) -> Dict[str, float]:
    """The fleet-series keys the policy reads, pulled into one flat
    dict (absent signals are simply not present — evaluate_policy
    treats missing latency signals as 'comfortable')."""
    out: Dict[str, float] = {}
    q = vals.get("queue_depth_sum", vals.get("queue_depth"))
    if q is not None:
        out["queue"] = float(q)
    occ = vals.get("slot_occupancy_sum", vals.get("slot_occupancy"))
    if occ is not None:
        out["slot_occupancy"] = float(occ)
    ttft = vals.get("ttft_s_p95_s")
    if ttft is not None:
        out["ttft_p95_s"] = float(ttft)
    itl = vals.get("itl_s_p99_s")
    if itl is not None:
        out["itl_p99_s"] = float(itl)
    for k in ("replicas_live", "replicas_total", "fleet_up"):
        if k in vals:
            out[k] = float(vals[k])
    return out


def _pressure(policy: ScalingPolicy,
              signals: Dict[str, float]) -> Tuple[int, str]:
    """(direction, reason): +1 scale-up pressure, -1 scale-down
    pressure, 0 in the hysteresis band."""
    queue = signals.get("queue", 0.0)
    ttft = signals.get("ttft_p95_s")
    itl = signals.get("itl_p99_s")
    if queue > policy.queue_high:
        return 1, REASON_QUEUE_HIGH
    if policy.ttft_p95_high_s > 0 and ttft is not None \
            and ttft > policy.ttft_p95_high_s:
        return 1, REASON_TTFT_HIGH
    if policy.itl_p99_high_s > 0 and itl is not None \
            and itl > policy.itl_p99_high_s:
        return 1, REASON_ITL_HIGH
    if queue < policy.queue_low:
        return -1, REASON_QUEUE_LOW
    return 0, REASON_STEADY


def evaluate_policy(policy: ScalingPolicy, current: int,
                    signals: Optional[Dict[str, float]], age_s: float,
                    streak: Tuple[int, int],
                    since_up_s: float, since_down_s: float,
                    ) -> Tuple[Decision, Tuple[int, int]]:
    """Pure policy math: one tick's verdict plus the updated
    (direction, length) breach streak. ``signals=None`` means no fleet
    point exists. ``since_up_s`` is seconds since the last scale-up
    (gates the next up); ``since_down_s`` is seconds since the last
    action in EITHER direction — a fresh spawn relieving the queue must
    not trigger an immediate drain of the replica it just paid for
    (``inf`` when never)."""
    sig = signals or {}

    def hold(reason: str) -> Decision:
        return Decision(ACTION_HOLD, current, reason, current, sig)

    if signals is None:
        return hold(REASON_NO_DATA), (0, 0)
    if age_s > policy.stale_after_s:
        return hold(REASON_STALE_DATA), (0, 0)
    direction, reason = _pressure(policy, signals)
    last_dir, length = streak
    length = length + 1 if direction == last_dir else 1
    streak = (direction, length)
    if direction == 0:
        return hold(REASON_STEADY), streak
    if direction > 0:
        if current >= policy.max_replicas:
            return hold(REASON_AT_MAX), streak
        if length < policy.up_sustain:
            return hold(REASON_SUSTAIN), streak
        if since_up_s < policy.up_cooldown_s:
            return hold(REASON_COOLDOWN), streak
        return (
            Decision(ACTION_UP, current + 1, reason, current, sig),
            streak,
        )
    if current <= policy.min_replicas:
        return hold(REASON_AT_MIN), streak
    if length < policy.down_sustain:
        return hold(REASON_SUSTAIN), streak
    if since_down_s < policy.down_cooldown_s:
        return hold(REASON_COOLDOWN), streak
    return (
        Decision(ACTION_DOWN, current - 1, reason, current, sig),
        streak,
    )


class Autoscaler:
    """Stateful decide loop over a TSDB reader. The caller ticks
    ``decide(n_current)`` on its own cadence and executes the returned
    decision; hysteresis streaks and cooldown clocks live here."""

    def __init__(self, policy: ScalingPolicy, reader=None,
                 clock: Callable[[], float] = time.time,
                 emit=None):
        self.policy = policy
        self.reader = reader
        self._clock = clock
        self._emit = emit
        self._streak: Tuple[int, int] = (0, 0)
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        self._last_hold_reason: Optional[str] = None

    # -- input ------------------------------------------------------------

    def _latest_point(self) -> Optional[Tuple[float, Dict[str, float]]]:
        """Latest aggregated fleet point from the TSDB, or None."""
        from progen_tpu_torch.telemetry.collector import fleet_series

        if self.reader is None:
            return None
        samples = [
            rec for rec in self.reader.read()
            if rec.get("ev") == "sample"
        ]
        series = fleet_series(samples)
        return series[-1] if series else None

    # -- output -----------------------------------------------------------

    def _record(self, decision: Decision, now: float) -> None:
        """Edge-triggered scale records: every up/down, holds only on a
        reason change — the trace shows transitions, not steady state."""
        if decision.action == ACTION_HOLD:
            if decision.reason == self._last_hold_reason:
                return
            self._last_hold_reason = decision.reason
        else:
            self._last_hold_reason = None
        try:
            from progen_tpu_torch import telemetry

            rec = {
                "ev": "scale", "ts": now,
                "action": decision.action,
                "reason": decision.reason,
                "current": int(decision.current),
                "target": int(decision.target),
            }
            for k, v in decision.signals.items():
                rec[k] = round(float(v), 6)
            telemetry.get_telemetry().emit(rec)
        except Exception:
            pass
        if self._emit is not None:
            self._emit(decision)

    # -- the tick ---------------------------------------------------------

    def decide(self, current: int,
               now: Optional[float] = None) -> Decision:
        """One policy tick against the TSDB's latest fleet point.
        Chaos site ``autoscaler/decide`` fires first — a transient
        fault here must cost one tick, never the fleet (the caller
        catches ChaosError and skips)."""
        maybe_inject("autoscaler/decide")
        now = self._clock() if now is None else now
        point = self._latest_point()
        signals: Optional[Dict[str, float]] = None
        age_s = float("inf")
        if point is not None:
            t, vals = point
            signals = extract_signals(vals)
            age_s = max(0.0, now - t)
        last_any = max(
            (t for t in (self._last_up, self._last_down)
             if t is not None),
            default=None,
        )
        decision, self._streak = evaluate_policy(
            self.policy, int(current), signals, age_s, self._streak,
            (float("inf") if self._last_up is None
             else now - self._last_up),
            (float("inf") if last_any is None else now - last_any),
        )
        if decision.action == ACTION_UP:
            self._last_up = now
        elif decision.action == ACTION_DOWN:
            self._last_down = now
        self._record(decision, now)
        return decision


def read_scale_records(path) -> List[dict]:
    """All ``ev:"scale"`` records in an events JSONL (what the CI
    smoke and tests assert against)."""
    from progen_tpu_torch.telemetry.trace import iter_jsonl

    return [r for r in iter_jsonl(path) if r.get("ev") == "scale"]
