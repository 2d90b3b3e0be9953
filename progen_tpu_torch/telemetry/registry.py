"""Shared metrics registry: counters, gauges, timing reservoirs.

The port's copy of the JAX package's ``telemetry/registry.py``, whole.
The process-global ``MetricsRegistry`` is where anything bound for a
dashboard lands: monotonic counters (retries, rollbacks, quarantines,
chaos injections, stalls), gauges (goodput %, MFU, device memory) and
timing reservoirs (step time quantiles). ``_Timing`` is the bounded
Vitter Algorithm-R reservoir that ``serving.metrics`` also uses; its
worst-K exemplars tie a slow quantile to the traces that made it slow.

Thread-safe by a single lock: the retry path, the watchdog thread and
the async checkpoint's writer increment concurrently with the train
loop. ``structured()`` has the shape ``telemetry.prometheus_text``
consumes, so the registry plugs into the file and HTTP exposition.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Dict

_RESERVOIR_CAP = 512
_QUANTILES = ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s"))
# worst-K trace exemplars retained per family: enough to name the
# requests behind a burning p99, small enough to ride every exposition
_EXEMPLAR_CAP = 4


class _Timing:
    """Running sum/count/min/max plus a fixed-size uniform reservoir
    (Vitter's Algorithm R) for tail quantiles — latency SLOs live at
    p99, where a mean is actively misleading. Seeded RNG keeps runs
    reproducible; memory is bounded at ``_RESERVOIR_CAP`` floats per
    timing family regardless of observation count.

    Observations that carry a ``trace_id`` additionally compete for the
    worst-K exemplar slots (Dapper's aggregate→trace link): the K
    largest values seen, each with the trace that produced it, so "p99
    is slow" resolves to specific request ids."""

    __slots__ = ("sum", "count", "min", "max", "_reservoir", "_rng",
                 "_exemplars")

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = 0.0
        self._reservoir: list = []
        self._rng = random.Random(0)
        self._exemplars: list = []  # [(value, trace_id)], worst first

    @staticmethod
    def _worst_k(pairs) -> list:
        """Top-``_EXEMPLAR_CAP`` (value, trace_id) pairs, one slot per
        trace (a trace observed twice keeps its worst value)."""
        best: Dict[str, float] = {}
        for v, tid in pairs:
            if tid not in best or v > best[tid]:
                best[tid] = v
        ranked = sorted(((v, t) for t, v in best.items()), reverse=True)
        return ranked[:_EXEMPLAR_CAP]

    def observe(self, v: float, trace_id=None) -> None:
        self.sum += v
        self.count += 1
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._reservoir) < _RESERVOIR_CAP:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < _RESERVOIR_CAP:
                self._reservoir[j] = v
        if trace_id:
            self._exemplars = self._worst_k(
                self._exemplars + [(float(v), str(trace_id))]
            )

    def exemplars(self) -> list:
        """Worst-K observations with their traces, worst first."""
        return [
            {"value": v, "trace_id": tid} for v, tid in self._exemplars
        ]

    def quantile(self, q: float) -> float:
        if not self._reservoir:
            return 0.0
        xs = sorted(self._reservoir)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def stats(self) -> Dict[str, float]:
        mean = self.sum / self.count if self.count else 0.0
        out = {
            "mean_s": mean,
            "max_s": self.max,
            "min_s": self.min if self.count else 0.0,
            "count": float(self.count),
            # cumulative sum rides along because fleet-level averages
            # are only mergeable from (sum, count) pairs — a mean (or
            # quantiles) per source cannot be combined after the fact
            "sum": self.sum,
        }
        for q, key in _QUANTILES:
            out[key] = self.quantile(q)
        return out

    @classmethod
    def merged(cls, parts) -> "_Timing":
        """Combine reservoirs from several sources into one _Timing.
        sum/count/min/max merge exactly; the merged reservoir is a
        count-weighted subsample (Efraimidis–Spirakis keys, seeded) of
        the parts' reservoirs, so each part's influence on the merged
        quantiles matches its share of observations, not its share of
        reservoir slots."""
        out = cls()
        parts = [p for p in parts if p.count > 0]
        if not parts:
            return out
        out.count = sum(p.count for p in parts)
        out.sum = sum(p.sum for p in parts)
        out.min = min(p.min for p in parts)
        out.max = max(p.max for p in parts)
        # exemplars union exactly: the fleet's worst-K is the worst-K
        # of the parts' worst-Ks (max is order-insensitive)
        out._exemplars = cls._worst_k(
            pair for p in parts for pair in p._exemplars
        )
        pool = []
        for p in parts:
            if not p._reservoir:
                continue
            w = p.count / len(p._reservoir)
            pool.extend((v, w) for v in p._reservoir)
        if len(pool) <= _RESERVOIR_CAP:
            out._reservoir = [v for v, _ in pool]
        else:
            rng = random.Random(0)
            keyed = sorted(
                pool,
                key=lambda vw: rng.random() ** (1.0 / vw[1]),
                reverse=True,
            )
            out._reservoir = [v for v, _ in keyed[:_RESERVOIR_CAP]]
        return out


class MetricsRegistry:
    """Process-wide counters (monotonic), gauges (last value), and
    timings (reservoir quantiles), safe under concurrent writers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._timings: Dict[str, _Timing] = {}

    def inc(self, name: str, by: float = 1) -> None:
        """Increment a counter; ``by=0`` declares it (so an exposition
        shows the zero instead of omitting the family)."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + by

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def set_gauges(self, mapping: Dict[str, float]) -> None:
        with self._lock:
            for k, v in mapping.items():
                self.gauges[k] = float(v)

    def observe(self, name: str, seconds: float, trace_id=None) -> None:
        with self._lock:
            self._timings.setdefault(name, _Timing()).observe(
                seconds, trace_id=trace_id
            )

    def snapshot(self) -> Dict[str, float]:
        """Flat dict of everything — tracker-loggable."""
        with self._lock:
            out: Dict[str, float] = {
                k: float(v) for k, v in self.counters.items()
            }
            out.update(self.gauges)
            for name, t in self._timings.items():
                for stat, v in t.stats().items():
                    out[f"{name}_{stat}"] = v
            return out

    def structured(self) -> dict:
        """Typed view in the shape ``prometheus_text`` consumes."""
        with self._lock:
            return {
                "counters": {
                    k: float(v) for k, v in self.counters.items()
                },
                "gauges": dict(self.gauges),
                "derived": {},
                "timings": {
                    name: {
                        "sum": t.sum,
                        "count": t.count,
                        "quantiles": {
                            str(q): t.quantile(q) for q, _ in _QUANTILES
                        },
                        **(
                            {"exemplars": t.exemplars()}
                            if t._exemplars else {}
                        ),
                    }
                    for name, t in self._timings.items()
                },
            }

    def reset(self) -> None:
        """Zero everything — called at CLI entry so one process running
        several runs (tests calling ``run(argv)``) never bleeds counts
        across."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self._timings.clear()


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL
