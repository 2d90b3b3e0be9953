"""events.jsonl → Chrome Trace Event / Perfetto JSON.

The span stream (``spans.py``) already writes Dapper-style B/E pairs;
this module is the ``json.dumps`` between that file and a real trace
viewer (``ui.perfetto.dev`` or ``chrome://tracing``). The mapping is
direct by design:

  * span ``B``/``E`` records → duration-begin/end slices, ``ts`` in
    microseconds, ``pid`` = host (``host_index()``, the process rank, stamped
    by ``Telemetry.emit``), ``tid`` = OS thread — so a two-host run
    renders as two process tracks and the watchdog/checkpoint threads
    get their own rows;
  * one-shot records (``retry``, ``anomaly``, ``stall``, ``chaos``,
    ``ckpt_commit_failed``, ``clock_beacon``, …) → instant events
    (``ph: "i"``) pinned to their host track;
  * serving ``req`` records (scheduler lifecycle: queued → prefill →
    decode, emitted with ``ph: "b"/"n"/"e"`` and the request id) →
    async trace events (``cat: "request"``, ``id`` = request) — every
    accepted request renders as ONE async track with its phases nested
    under it, instants for first_token/deadline_exceeded riding the
    same track;
  * ``slots`` records → a ``slot_occupancy`` counter track (in-use vs
    free decode lanes over time);
  * each ``retry`` additionally opens a flow arrow (``ph: "s"`` →
    ``ph: "f"``, ``bp: "e"``) from the retry instant to the END of the
    innermost span open on that host when it fired — the viewer draws
    the line from the fault to the operation that absorbed its latency
    (an IO retry inside ``ckpt/save`` visibly bills the save, not the
    step). A retry outside any open span stays a bare instant;
  * ``goodput_host`` records and metrics.jsonl rows → counter tracks
    (``ph: "C"``): ``step_ms``, ``mfu``, ``tokens_per_sec_per_chip``,
    ``goodput_pct``, stacked ``goodput_bucket_s`` series, and the HBM
    gauges;
  * ``M`` metadata names each pid ``host N`` and each tid by its
    recorded thread name.

The per-host goodput *skew* table rides along as an extra top-level key
(``progenGoodputSkew``) — trace viewers ignore unknown top-level keys,
so one file serves both the viewer and the summarize tooling.

The port's copy of the JAX package's ``telemetry/trace.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator, Optional

from progen_tpu_torch.telemetry.goodput import goodput_skew

# record keys that map onto trace-event structure rather than args
_STRUCTURAL = {"ev", "span", "id", "ts", "pid", "tid", "thread"}

# req-record keys that map onto async-event structure rather than args
_REQ_STRUCTURAL = _STRUCTURAL | {"ph", "name", "req"}

# one-shot telemetry records rendered as instant events on the host track
INSTANT_EVENTS = (
    "retry", "anomaly", "anomaly_rollback", "stall", "stall_escalation",
    "ckpt_quarantine", "ckpt_commit_failed", "chaos", "goodput",
    "clock_beacon", "request_rejected", "reload", "journal_replay",
    "route", "slo", "alert", "flight", "profile",
)

# metrics.jsonl columns that get their own counter track
_SCALAR_COUNTERS = (
    "step_ms", "mfu", "tokens_per_sec_per_chip", "goodput_pct",
)


class LineDrops:
    """Tally of torn/garbage lines ``iter_jsonl`` skipped. A trace that
    quietly lost records is an observability bug, so every CLI surface
    (export-trace, summarize, stitch) threads one of these through its
    reads and reports the total."""

    __slots__ = ("count",)

    def __init__(self):
        self.count = 0


def iter_jsonl(path, drops: Optional[LineDrops] = None) -> Iterator[dict]:
    """Parsed records, one per line; a torn final line (the crash-safety
    contract allows exactly one) or stray garbage is skipped, not fatal
    — a trace of a crashed run is the whole point. Skips are counted
    into ``drops`` so callers can surface how many lines the trace is
    missing."""
    with Path(path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if drops is not None:
                    drops.count += 1
                continue
            if isinstance(rec, dict):
                yield rec
            elif drops is not None:
                drops.count += 1


def iter_events_any(
    path, drops: Optional[LineDrops] = None
) -> Iterator[dict]:
    """Telemetry records from events.jsonl OR a flight-recorder dump.

    A crashed host leaves no events.jsonl tail past its last flush —
    its black box (``flight-<host>-<ts>.json``, telemetry/flight.py)
    holds the final seconds instead. Dumps replay their captured ring
    through the same iterator shape, so export-trace and stitch render
    a dead host's last moments exactly like a survivor's stream. A dump
    that fails digest verification counts as one dropped line rather
    than raising: a torn dump from a badly-timed kill must not take the
    rest of a fleet trace down with it."""
    from progen_tpu_torch.telemetry import flight

    if flight.is_dump_path(path):
        try:
            records = flight.dump_records(path)
        except (OSError, ValueError):
            if drops is not None:
                drops.count += 1
            return
        for rec in records:
            if isinstance(rec, dict):
                yield rec
            elif drops is not None:
                drops.count += 1
        return
    yield from iter_jsonl(path, drops)


def _us(ts: float) -> float:
    return float(ts) * 1e6


def _args(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in _STRUCTURAL}


def _counter(name: str, ts: float, pid: int, series: dict) -> dict:
    return {
        "ph": "C", "name": name, "ts": _us(ts), "pid": pid, "tid": 0,
        "args": series,
    }


def _goodput_counters(rec: dict, ts: float, pid: int) -> list:
    out = []
    if "goodput_pct" in rec:
        out.append(_counter(
            "goodput_pct", ts, pid, {"goodput_pct": rec["goodput_pct"]}
        ))
    buckets = {
        k.split("/", 1)[1]: v
        for k, v in rec.items() if k.startswith("bucket_s/")
    }
    if buckets:
        out.append(_counter("goodput_bucket_s", ts, pid, buckets))
    return out


def build_trace(
    events: Iterable[dict], metrics: Iterable[dict] = ()
) -> dict:
    """Assemble the Trace Event JSON object from parsed events.jsonl
    records (and optionally metrics.jsonl rows for the perf counter
    tracks). Returns the dict — callers ``json.dump`` it."""
    trace_events: list = []
    meta: list = []
    seen_pids: set = set()
    seen_tids: set = set()
    host_reports: dict = {}
    # retry→absorbing-span flow state: per-pid stack of open spans in
    # input order; a retry binds to the innermost one, and the matching
    # flow-end lands when that span's E arrives. Spans that never close
    # (crash mid-span) leave an s-only flow — viewers render the start
    # arrowhead, which is the honest picture.
    open_spans: dict = {}
    flow_id = 0

    def _note_pid(pid: int) -> None:
        if pid not in seen_pids:
            seen_pids.add(pid)
            meta.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"host {pid}"},
            })

    for rec in events:
        ev = rec.get("ev")
        ts = rec.get("ts")
        if ev is None or ts is None:
            continue
        pid = int(rec.get("pid", 0))
        if ev in ("B", "E"):
            tid = int(rec.get("tid", 0) or 0)
            _note_pid(pid)
            thread = rec.get("thread")
            if thread and (pid, tid) not in seen_tids:
                seen_tids.add((pid, tid))
                meta.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": str(thread)},
                })
            trace_events.append({
                "ph": ev, "name": str(rec.get("span", "?")),
                "cat": "span", "ts": _us(ts), "pid": pid, "tid": tid,
                "args": _args(rec),
            })
            if ev == "B":
                open_spans.setdefault(pid, []).append(
                    {"tid": tid, "pending": []}
                )
            else:
                stack = open_spans.get(pid) or []
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i]["tid"] != tid:
                        continue
                    for fid in stack.pop(i)["pending"]:
                        trace_events.append({
                            "ph": "f", "bp": "e", "cat": "flow",
                            "name": "retry_absorbed", "id": fid,
                            "ts": _us(ts), "pid": pid, "tid": tid,
                        })
                    break
        elif ev == "req":
            # serving request lifecycle: async begin/instant/end keyed
            # on the request id, one async track per request
            ph = rec.get("ph")
            rid = rec.get("req")
            if ph not in ("b", "n", "e") or rid is None:
                continue
            _note_pid(pid)
            trace_events.append({
                "ph": ph, "cat": "request",
                "name": str(rec.get("name", "request")),
                "id": str(rid), "ts": _us(ts), "pid": pid, "tid": 0,
                "args": {
                    k: v for k, v in rec.items()
                    if k not in _REQ_STRUCTURAL
                },
            })
        elif ev == "slots":
            _note_pid(pid)
            trace_events.append(_counter("slot_occupancy", ts, pid, {
                k: rec[k] for k in ("in_use", "free") if k in rec
            }))
        elif ev == "goodput_host":
            host = int(rec.get("host", pid))
            _note_pid(host)
            host_reports[host] = {
                k: v for k, v in rec.items()
                if k not in ("ev", "ts", "host", "pid")
            }
            trace_events.extend(_goodput_counters(rec, ts, host))
        elif ev in INSTANT_EVENTS:
            _note_pid(pid)
            trace_events.append({
                "ph": "i", "name": str(ev), "cat": "event",
                "ts": _us(ts), "pid": pid, "tid": 0, "s": "p",
                "args": _args(rec),
            })
            if ev == "retry":
                stack = open_spans.get(pid) or []
                if stack:
                    frame = stack[-1]
                    flow_id += 1
                    frame["pending"].append(flow_id)
                    trace_events.append({
                        "ph": "s", "cat": "flow",
                        "name": "retry_absorbed", "id": flow_id,
                        "ts": _us(ts), "pid": pid, "tid": frame["tid"],
                    })

    for rec in metrics:
        ts = rec.get("_time")
        if ts is None:
            continue
        pid = int(rec.get("pid", 0))
        _note_pid(pid)
        for key in _SCALAR_COUNTERS:
            if key in rec:
                trace_events.append(
                    _counter(key, ts, pid, {key: rec[key]})
                )
        buckets = {
            k.split("/", 1)[1]: v
            for k, v in rec.items() if k.startswith("bucket_s/")
        }
        if buckets:
            trace_events.append(
                _counter("goodput_bucket_s", ts, pid, buckets)
            )
        hbm = {
            k.split("/", 1)[1]: v
            for k, v in rec.items() if k.startswith("hbm/")
        }
        if hbm:
            trace_events.append(_counter("hbm", ts, pid, hbm))

    # stable sort: records at the same ts keep file order, so a B always
    # precedes its zero-duration E and viewers never see a negative nest
    trace_events.sort(key=lambda e: e["ts"])
    out = {
        "traceEvents": meta + trace_events,
        "displayTimeUnit": "ms",
    }
    if host_reports:
        reports = [host_reports[h] for h in sorted(host_reports)]
        out["progenGoodputSkew"] = goodput_skew(reports)
    return out


def export_trace(
    events_path, out_path, metrics_path: Optional[str] = None
) -> dict:
    """File-to-file convenience used by the CLI: read events.jsonl (and
    metrics.jsonl when present), write Trace Event JSON, return the
    trace dict. ``progenDroppedLines`` on the result counts torn/
    garbage lines the readers had to skip."""
    drops = LineDrops()
    metrics: list = []
    if metrics_path is not None and Path(metrics_path).exists():
        metrics = list(iter_jsonl(metrics_path, drops))
    trace = build_trace(iter_events_any(events_path, drops), metrics)
    trace["progenDroppedLines"] = drops.count
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("w") as f:
        json.dump(trace, f)
    return trace
