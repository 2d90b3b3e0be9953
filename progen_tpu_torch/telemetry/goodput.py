"""Goodput ledger: classify every second of loop wall clock.

The port's copy of the JAX package's ``telemetry/goodput.py``. MegaScale
(NSDI'24) frames large-run efficiency as *goodput* — the fraction of
wall clock the accelerators spend on actual training steps — and gets
there by accounting for everything else explicitly. This ledger is that
accounting for one process: the train loop wraps each kind of work in
``ledger.track(bucket)`` and ``report()`` divides.

Buckets (``BUCKETS``): ``compile`` (the first step: the kernels' build
and load and the libraries' warm-up), ``step`` (the device step and the
host sync that observes it), ``data`` (host input pipeline),
``checkpoint``, ``eval``, ``sample``, ``log`` (tracker/console IO).
Whatever no one claimed lands in ``other`` — the report always sums to
wall clock exactly, so a low ``coverage_pct`` is itself a finding
(unattributed time), not a bookkeeping artifact.

MFU says how fast the step is; ``goodput_pct`` says how often the loop
is actually stepping. Both are needed: a 40%-MFU step inside a
50%-goodput loop is a 20%-efficient run.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

BUCKETS = (
    "compile", "step", "data", "checkpoint", "eval", "sample", "log",
)


class _Tracked:
    """Handle yielded by ``track`` — ``seconds`` is set on exit so the
    caller can forward the same measurement elsewhere (e.g.
    ``StepTimer.exclude``) without re-timing."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


class GoodputLedger:
    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._acc: Dict[str, float] = {}

    def account(self, bucket: str, seconds: float) -> None:
        self._acc[bucket] = self._acc.get(bucket, 0.0) + max(seconds, 0.0)

    @contextlib.contextmanager
    def track(self, bucket: str):
        t0 = self._clock()
        handle = _Tracked()
        try:
            yield handle
        finally:
            handle.seconds = self._clock() - t0
            self.account(bucket, handle.seconds)

    @property
    def wall_s(self) -> float:
        return self._clock() - self._t0

    def report(self) -> dict:
        """Flat dict, tracker-loggable. ``bucket_s/*`` (incl. ``other``)
        sums to ``wall_s`` exactly; ``goodput_pct`` = step share;
        ``coverage_pct`` = attributed share (the ≥95% health check)."""
        wall = max(self.wall_s, 1e-9)
        tracked = sum(self._acc.values())
        out = {"wall_s": round(wall, 4)}
        for b in (*BUCKETS, *sorted(set(self._acc) - set(BUCKETS))):
            if b in self._acc:
                out[f"bucket_s/{b}"] = round(self._acc[b], 4)
        out["bucket_s/other"] = round(max(wall - tracked, 0.0), 4)
        out["goodput_pct"] = round(
            100.0 * self._acc.get("step", 0.0) / wall, 2
        )
        out["coverage_pct"] = round(100.0 * min(tracked / wall, 1.0), 2)
        return out


def _report_from_vector(wall: float, bucket_s: Dict[str, float]) -> dict:
    """Rebuild a ``report()``-shaped dict from raw (wall, bucket) seconds
    — used for the *other* hosts' vectors after the allgather."""
    wall = max(wall, 1e-9)
    tracked = sum(bucket_s.values())
    out = {"wall_s": round(wall, 4)}
    for b in BUCKETS:
        if bucket_s.get(b, 0.0) > 0.0:
            out[f"bucket_s/{b}"] = round(bucket_s[b], 4)
    out["bucket_s/other"] = round(max(wall - tracked, 0.0), 4)
    out["goodput_pct"] = round(100.0 * bucket_s.get("step", 0.0) / wall, 2)
    out["coverage_pct"] = round(100.0 * min(tracked / wall, 1.0), 2)
    return out


def per_host_reports(ledger: "GoodputLedger") -> list:
    """One ``report()`` dict per process, index == its rank.

    COLLECTIVE on a grid — every process must reach this call (it rides
    ``torch.distributed.all_gather_object`` of ``[wall_s, *bucket
    seconds]`` over the default group). With one process, or no process
    group, it degrades to ``[ledger.report()]`` with no collective, so
    CPU tests exercise the same code path.

    Custom buckets beyond ``BUCKETS`` stay host-local (the wire format
    is fixed-width so hosts can't disagree on vector length); their
    time lands in that host's ``other``, which is still attributed
    wall clock — the cross-host *skew* story is unaffected.
    """
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() <= 1:
        return [ledger.report()]
    vec = [ledger.wall_s] + [ledger._acc.get(b, 0.0) for b in BUCKETS]
    gathered: list = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, vec)
    reports = []
    for row in gathered:
        bucket_s = {b: float(row[1 + i]) for i, b in enumerate(BUCKETS)}
        reports.append(_report_from_vector(float(row[0]), bucket_s))
    return reports


def goodput_skew(host_reports: list) -> dict:
    """Per-bucket min/max/skew across hosts + the straggler for each.

    ``skew_s`` is max-min bucket seconds; the host holding the max is
    the straggler (a host stuck in ``data`` or ``checkpoint`` shows up
    here as its own skew line — MegaScale's straggler table)."""
    out: dict = {"hosts": len(host_reports)}
    if not host_reports:
        return out
    buckets = sorted(
        {k for rep in host_reports for k in rep if k.startswith("bucket_s/")}
    )
    for key in ("goodput_pct", *buckets):
        vals = [float(rep.get(key, 0.0)) for rep in host_reports]
        lo, hi = min(vals), max(vals)
        name = key.split("/", 1)[-1] if "/" in key else key
        out[name] = {
            "min": round(lo, 4),
            "max": round(hi, 4),
            "skew": round(hi - lo, 4),
            "straggler": int(vals.index(hi)),
        }
    return out


def emit_per_host_goodput(ledger: "GoodputLedger", emit=None) -> list:
    """Gather per-host reports (collective — see ``per_host_reports``)
    and emit one ``{"ev": "goodput_host", "host": i, ...}`` record per
    host through the process telemetry (or an explicit ``emit``). Every
    host emits the full table into its own event file, so any single
    host's ``events.jsonl`` is enough to reconstruct the skew."""
    reports = per_host_reports(ledger)
    if emit is None:
        from progen_tpu_torch.telemetry import spans

        emit = spans.get_telemetry().emit
    now = time.time()
    for i, rep in enumerate(reports):
        emit({"ev": "goodput_host", "ts": now, "host": i, **rep})
    return reports
