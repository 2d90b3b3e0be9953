"""Serving metrics: counters, gauges and timing observations.

The port's copy of the JAX package's ``serving/metrics.py``.
Single-threaded (the scheduler owns the loop); ``log_to(tracker)``
flattens a snapshot into the tracker's ``log(dict, step)`` under a
``serve/`` prefix, so serving runs land in the same metrics.jsonl as
training runs.

Throughput is derived, not sampled: the scheduler accumulates exact
token counts and host time around the prefill and decode calls, and
``snapshot()`` divides. Latency lands in three reservoir families:
``ttft_s`` (submit to first token), ``itl_s`` (the gap between two
tokens of one request) and ``latency_s`` (submit to done); an
observation with a ``trace_id`` competes for the family's worst-K
exemplars. ``structured()`` is the typed view the Prometheus exposition
(``telemetry.prometheus_text``) renders.
"""

from __future__ import annotations

from typing import Dict, Optional

from progen_tpu_torch.telemetry.registry import _QUANTILES, _Timing


class ServingMetrics:
    """Counters (monotonic), gauges (last value), timings (reservoirs)
    and time accumulators (for derived throughput)."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self._timings: Dict[str, _Timing] = {}
        self._times: Dict[str, float] = {}

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float, trace_id=None) -> None:
        self._timings.setdefault(name, _Timing()).observe(
            seconds, trace_id=trace_id)

    def declare_timing(self, name: str) -> None:
        """Register a timing family at zero observations, so a snapshot
        carries it from the start."""
        self._timings.setdefault(name, _Timing())

    def add_time(self, name: str, seconds: float) -> None:
        self._times[name] = self._times.get(name, 0.0) + seconds

    def _derived(self) -> Dict[str, float]:
        out = {}
        for rate, count, time in (
                ("decode_tokens_per_s", "decode_tokens", "decode_time_s"),
                ("prefill_tokens_per_s", "prefill_tokens",
                 "prefill_time_s")):
            t = self._times.get(time, 0.0)
            if t > 0:
                out[rate] = self.counters.get(count, 0) / t
        return out

    def snapshot(self) -> Dict[str, float]:
        """Flat dict of everything, plus the derived tokens/s rates."""
        out: Dict[str, float] = {k: float(v)
                                 for k, v in self.counters.items()}
        out.update(self.gauges)
        out.update(self._times)
        for name, t in self._timings.items():
            for stat, v in t.stats().items():
                out[f"{name}_{stat}"] = v
        out.update(self._derived())
        return out

    def structured(self) -> dict:
        """Typed view for exposition formats that distinguish metric
        kinds (``telemetry.prometheus``): counters (monotonic, the
        accumulated-time counters included), gauges, derived rates, and
        timings with reservoir quantiles and exemplars."""
        return {
            "counters": {
                **{k: float(v) for k, v in self.counters.items()},
                **self._times,
            },
            "gauges": dict(self.gauges),
            "derived": self._derived(),
            "timings": {
                name: {
                    "sum": t.sum,
                    "count": t.count,
                    "quantiles": {
                        str(q): t.quantile(q) for q, _ in _QUANTILES
                    },
                    **({"exemplars": t.exemplars()}
                       if t._exemplars else {}),
                }
                for name, t in self._timings.items()
            },
        }

    def log_to(self, tracker, step: Optional[int] = None,
               prefix: str = "serve/") -> None:
        """Emit the snapshot through a tracker's ``log(dict, step)``."""
        tracker.log(
            {f"{prefix}{k}": v for k, v in self.snapshot().items()}, step
        )
