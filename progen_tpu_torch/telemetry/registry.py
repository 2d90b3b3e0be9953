"""Timing reservoirs: the part of the JAX package's
``telemetry/registry.py`` that serving metrics use.

``_Timing`` keeps a running sum, count, min and max and a bounded
uniform reservoir (Vitter's Algorithm R) for tail quantiles: a latency
objective lives at p99, where a mean misleads. The JAX registry's
process-wide ``MetricsRegistry``, its trace exemplars and the merge of
reservoirs serve the Prometheus exposition and the fleet collector,
which come with the host-side stack.
"""

from __future__ import annotations

import math
import random
from typing import Dict

_RESERVOIR_CAP = 512
_QUANTILES = ((0.5, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s"))


class _Timing:
    """Running sum/count/min/max plus a fixed-size uniform reservoir.
    The reservoir's RNG is seeded, so runs are reproducible; memory stays
    at ``_RESERVOIR_CAP`` floats per family whatever the count."""

    __slots__ = ("sum", "count", "min", "max", "_reservoir", "_rng")

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = 0.0
        self._reservoir: list = []
        self._rng = random.Random(0)

    def observe(self, v: float) -> None:
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
            # the sum rides along: averages over several sources merge
            # only from (sum, count) pairs
            "sum": self.sum,
        }
        for q, key in _QUANTILES:
            out[key] = self.quantile(q)
        return out
