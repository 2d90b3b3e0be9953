"""Prometheus remote-write bridge for the merged fleet series.

The collector (``telemetry/collector.py``) already produces the hard
part — a reset-safe merged fleet series (counters rebased across
respawns, exact ``sum``/``count``, mixture-CDF quantile merge). This
module gets that series OFF the box: each scrape tick becomes one
remote-write *point* (a timestamped set of timeseries) pushed over
plain HTTP to a configurable endpoint.

Wire format: remote-write v1's shape without the protobuf+snappy
framing — a JSON body ``{"timeseries": [{"labels": {...},
"samples": [[ms, value], ...]}, ...]}`` where labels carry
``__name__`` (and ``quantile`` for summary series). Series names use
Prometheus conventions so a scrape-side ``parse_prom_text`` of the
rendered payload round-trips to the collector's own normalized keys:

  * counters        → ``progen_<name>_total``
  * gauges          → ``progen_<name>``
  * timing families → ``progen_<fam>_seconds{quantile="0.5|0.95|0.99"}``
    plus ``progen_<fam>_seconds_sum`` / ``_count`` (the derived
    ``<fam>_mean_s`` gauge is omitted — it is ``sum/count`` in PromQL)

One deliberate omission from this bridge: the worst-K trace exemplars
that ride the scrape-side exposition as OpenMetrics
``# {trace_id="..."} value`` annotations (see
``telemetry.prometheus.escape_label_value`` for the backslash/quote/
newline escaping both sides of that contract must share — the
trace_id is operator-influenced text inside a quoted label, so a raw
``"`` or ``\\n`` would tear the exposition line). Remote-write v1 has
no exemplar field; the fleet's exemplars stay queryable locally via
the TSDB samples and ``progen-tpu-torch-telemetry query --trace``, and the
escape/unescape pair (``telemetry.slo.unescape_label_value``) is what
keeps them intact from replica exposition through collector merge.

Delivery discipline (the part that keeps the scrape loop honest):

  * ``offer()`` never blocks and never raises — points land in a
    bounded in-memory spool; overflow drops the OLDEST point and
    counts it (``dropped_points``), so a dead endpoint costs history,
    never liveness;
  * ``flush()`` pushes up to ``batch_points`` spooled points per call
    and returns immediately on failure — the failed batch goes back to
    the spool head and the next attempt waits out an exponential
    backoff computed from :class:`resilience.retry.RetryPolicy`
    (``PROGEN_RETRY_BASE_S``/``_MAX_S`` env knobs apply), so a flapping
    receiver sees capped-rate retries instead of a tick-rate hammer.

The port's copy of the JAX package's ``telemetry/remote_write.py``.
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.request
from typing import Dict, Iterable, List, Optional, Set, Tuple

from progen_tpu_torch.resilience.retry import RetryPolicy, policy_from_env

# quantile suffix (collector's normalized key) <-> remote-write label
QUANTILE_SUFFIXES = (("_p50_s", "0.5"), ("_p95_s", "0.95"),
                     ("_p99_s", "0.99"))
SERIES_PREFIX = "progen_"


def fleet_kinds(samples: Iterable[dict]) -> Tuple[Set[str], Set[str]]:
    """(counter key names, timing family names) observed across a
    window of ``ev:"sample"`` records — the type information
    ``encode_point`` needs to pick Prometheus naming for each flat
    fleet-series key."""
    counters: Set[str] = set()
    timings: Set[str] = set()
    for rec in samples:
        counters.update(rec.get("counters") or {})
        timings.update(rec.get("timings") or {})
    return counters, timings


def encode_point(
    ts: float,
    vals: Dict[str, float],
    counters: Set[str],
    timings: Set[str],
) -> List[dict]:
    """One fleet-series point → a list of remote-write timeseries (one
    sample each). Timing-family keys expand to quantile-labeled
    ``_seconds`` series; counters gain ``_total``; everything else
    ships as a plain gauge under ``SERIES_PREFIX``."""
    ms = int(round(float(ts) * 1000.0))
    out: List[dict] = []

    def series(name: str, value, quantile: Optional[str] = None):
        labels = {"__name__": name}
        if quantile is not None:
            labels["quantile"] = quantile
        out.append({"labels": labels, "samples": [[ms, float(value)]]})

    handled: Set[str] = set()
    for fam in sorted(timings):
        base = SERIES_PREFIX + (
            fam[:-2] + "_seconds" if fam.endswith("_s")
            else fam + "_seconds"
        )
        for suffix, q in QUANTILE_SUFFIXES:
            key = fam + suffix
            handled.add(key)
            if key in vals:
                series(base, vals[key], quantile=q)
        for part in ("sum", "count"):
            key = f"{fam}_{part}"
            handled.add(key)
            if key in vals:
                series(f"{base}_{part}", vals[key])
        # mean is derivable (sum/count); omitted so the payload
        # round-trips through parse_prom_text without a synthetic name
        handled.add(f"{fam}_mean_s")
    for key in sorted(vals):
        if key in handled:
            continue
        if key in counters:
            series(f"{SERIES_PREFIX}{key}_total", vals[key])
        elif key.endswith(
            ("_total", "_seconds", "_seconds_sum", "_seconds_count")
        ):
            # a gauge whose own name ends in a suffix the scrape-side
            # normalizer rewrites (e.g. replicas_total): append one
            # _total — parse_prom_text strips exactly one, restoring
            # the original key, so round-trip equality holds
            series(f"{SERIES_PREFIX}{key}_total", vals[key])
        else:
            series(SERIES_PREFIX + key, vals[key])
    return out


def merge_timeseries(points: Iterable[List[dict]]) -> List[dict]:
    """Batch several points into one payload body: same-label series
    concatenate their samples in time order."""
    merged: Dict[Tuple, dict] = {}
    for point in points:
        for ts_entry in point:
            labels = ts_entry["labels"]
            key = tuple(sorted(labels.items()))
            slot = merged.get(key)
            if slot is None:
                merged[key] = {
                    "labels": dict(labels),
                    "samples": list(ts_entry["samples"]),
                }
            else:
                slot["samples"].extend(ts_entry["samples"])
    out = list(merged.values())
    for entry in out:
        entry["samples"].sort(key=lambda s: s[0])
    out.sort(key=lambda e: sorted(e["labels"].items()))
    return out


def payload_to_prom_text(payload: dict) -> str:
    """Render a payload body back to exposition text (latest sample per
    series) — what a test or a fake receiver feeds ``parse_prom_text``
    to prove the encoding round-trips to the collector's keys."""
    lines = []
    for entry in payload.get("timeseries", []):
        labels = dict(entry.get("labels") or {})
        name = labels.pop("__name__", "")
        samples = entry.get("samples") or []
        if not name or not samples:
            continue
        label_txt = ""
        if labels:
            inner = ",".join(
                f'{k}="{v}"' for k, v in sorted(labels.items())
            )
            label_txt = "{" + inner + "}"
        lines.append(f"{name}{label_txt} {samples[-1][1]}")
    return "\n".join(lines) + "\n"


class RemoteWriteBridge:
    """Bounded spool + batched HTTP push; see module doc for the
    delivery discipline."""

    def __init__(
        self,
        url: str,
        spool_points: int = 240,
        batch_points: int = 30,
        timeout_s: float = 5.0,
        policy: Optional[RetryPolicy] = None,
        opener=None,
    ):
        self.url = str(url)
        self.spool_points = max(1, int(spool_points))
        self.batch_points = max(1, int(batch_points))
        self.timeout_s = float(timeout_s)
        self.policy = policy if policy is not None else policy_from_env()
        # urlopen-compatible hook so tests can fail pushes hermetically
        self._opener = opener or urllib.request.urlopen
        self._rng = random.Random(f"{self.policy.seed}:remote_write")
        self._spool: List[List[dict]] = []
        self._failures = 0
        self._next_due = 0.0
        self.sent_points = 0
        self.sent_batches = 0
        self.dropped_points = 0
        self.push_failures = 0
        self.last_error = ""

    # -- spool ------------------------------------------------------------

    def offer(
        self,
        ts: float,
        vals: Dict[str, float],
        counters: Set[str],
        timings: Set[str],
    ) -> None:
        """Enqueue one fleet point. Never blocks, never raises; on
        overflow the OLDEST spooled point is dropped and counted."""
        try:
            point = encode_point(ts, vals, counters, timings)
        except Exception as exc:  # malformed vals must not kill a scrape
            self.last_error = f"encode: {exc}"
            return
        if not point:
            return
        self._spool.append(point)
        while len(self._spool) > self.spool_points:
            self._spool.pop(0)
            self.dropped_points += 1

    def spooled(self) -> int:
        return len(self._spool)

    # -- push -------------------------------------------------------------

    def _backoff_s(self) -> float:
        attempt = min(self._failures, self.policy.max_attempts) - 1
        return self.policy.delay(max(0, attempt), self._rng)

    def flush(self, now: float) -> str:
        """One bounded push attempt: ``"sent"``, ``"empty"``,
        ``"backoff"`` (still waiting out the last failure), or
        ``"failed"``. Failure re-spools the batch at the head so order
        is preserved; it never raises."""
        if not self._spool:
            return "empty"
        if now < self._next_due:
            return "backoff"
        batch = self._spool[: self.batch_points]
        payload = {"timeseries": merge_timeseries(batch)}
        body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={
                "Content-Type": "application/json",
                "X-Progen-Remote-Write": "v1-json",
            },
            method="POST",
        )
        try:
            with self._opener(req, timeout=self.timeout_s) as resp:
                status = getattr(resp, "status", 200)
                if int(status) >= 300:
                    raise urllib.error.HTTPError(
                        self.url, int(status), "push rejected", None, None
                    )
        except Exception as exc:
            self.push_failures += 1
            self._failures += 1
            self.last_error = str(exc)
            self._next_due = float(now) + self._backoff_s()
            return "failed"
        del self._spool[: len(batch)]
        self._failures = 0
        self._next_due = float(now)
        self.sent_points += len(batch)
        self.sent_batches += 1
        return "sent"

    def stats(self) -> Dict[str, float]:
        return {
            "sent_points": self.sent_points,
            "sent_batches": self.sent_batches,
            "dropped_points": self.dropped_points,
            "push_failures": self.push_failures,
            "spooled": len(self._spool),
        }
