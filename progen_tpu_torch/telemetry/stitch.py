"""Fleet stitching: N per-host event streams → ONE aligned trace.

A multi-host run leaves one ``events.jsonl`` per process, each stamped
with that host's wall clock — and host wall clocks disagree (NTP slew,
VM drift), so naively concatenating the files renders host 1's step 40
overlapping host 0's step 38. MegaScale-style fleet diagnosis
(PAPERS.md) needs all hosts on ONE timeline before a straggler is even
visible; this module is that merge.

Clock alignment rides on a shared reference event. The train loop emits
a ``clock_beacon`` record at every step boundary, immediately after the
host sync that observes the step's collective result — the gradient
all-reduce is a barrier every host crosses together, so the *true* time
of "step N done" is (to within the collective's skew, microseconds on a
healthy fabric) the same on every host, while the *recorded* times
differ by exactly the clock offsets. Per host, the offset is the median
over shared steps of (host's beacon ts − reference host's beacon ts):
the median is robust to the handful of steps where a host genuinely
lagged the barrier (a straggler step must not bend the clock). The
offset is then subtracted from ALL of that host's timestamps.

The stitched trace additionally gets:

  * a ``clock_beacon`` slice per (host, step) plus ``step_sync`` flow
    arrows from the reference host's beacon to every other host's —
    after correction the arrows are near-vertical; a straggling host
    renders as a visible arrow fan tilting toward it;
  * the fleet-wide ``progenGoodputSkew`` table (every host's
    ``goodput_host`` record is in the merged stream, deduped);
  * per-request JOURNEYS: ``req`` records carrying a ``trace_id``
    (router intake, replica lifecycle — serving/router.py mints the id,
    the wire carries it) are grouped per trace and linked with
    ``dispatch``/``handoff`` flow arrows from each router dispatch hop
    into the replica-side track it started — a midstream replica death
    renders as ONE contiguous journey: router queued → dispatch arrow →
    dead replica's partial decode → handoff arrow → the survivor's
    resumed track. The per-trace table rides along as ``progenTraces``;
  * ``progenClockOffsets`` (seconds subtracted per host) and
    ``progenDroppedLines`` (torn/garbage input lines) as top-level
    keys — trace viewers ignore unknown keys.

A serving fleet is N processes on (usually) one machine, all stamping
``pid`` 0 — ``force_hosts=True`` (CLI ``--force-hosts``) re-stamps each
stream with its argument position so router and replicas get distinct
process tracks (required for the journey arrows to have two ends).

The port's copy of the JAX package's ``telemetry/stitch.py``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

from progen_tpu_torch.telemetry.trace import (
    LineDrops,
    build_trace,
    iter_events_any,
    iter_jsonl,
)

# beacon anchor slices get a small fixed width so the step_sync flows
# have a slice to bind to and stay clickable at fleet zoom
_BEACON_DUR_US = 200.0


def emit_clock_beacon(step, emit=None) -> dict:
    """Emit one ``clock_beacon`` record for ``step`` and return it.

    Contract (see training/__init__.py): call this at each step
    boundary, immediately after the host-side sync on the step's
    collective result — that barrier is the shared reference event the
    stitcher aligns host clocks on. ``emit`` defaults to the
    process-global telemetry sink."""
    if emit is None:
        from progen_tpu_torch.telemetry.spans import get_telemetry

        emit = get_telemetry().emit
    rec = {"ev": "clock_beacon", "ts": time.time(), "step": int(step)}
    emit(rec)
    return rec


def collect_beacons(
    records: Iterable[dict],
) -> Dict[int, Dict[int, float]]:
    """host → {step → beacon ts} from ``clock_beacon`` records (the
    last record wins when a step repeats, e.g. after a rollback)."""
    out: Dict[int, Dict[int, float]] = {}
    for rec in records:
        if rec.get("ev") != "clock_beacon":
            continue
        ts = rec.get("ts")
        step = rec.get("step")
        if ts is None or step is None:
            continue
        out.setdefault(int(rec.get("pid", 0)), {})[int(step)] = float(ts)
    return out


def _median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    if n % 2:
        return s[mid]
    return (s[mid - 1] + s[mid]) / 2.0


def clock_offsets(
    beacons: Dict[int, Dict[int, float]], reference: int = 0
) -> Dict[int, float]:
    """Per-host clock offset in seconds, to SUBTRACT from that host's
    timestamps. Robust median of per-step beacon deltas vs the
    reference host (host 0 unless absent); hosts sharing no step with
    the reference keep offset 0 (nothing to align on beats a wild
    guess)."""
    if not beacons:
        return {}
    if reference not in beacons:
        reference = min(beacons)
    ref = beacons[reference]
    offsets: Dict[int, float] = {}
    for host, own in beacons.items():
        shared = [s for s in own if s in ref]
        if host == reference or not shared:
            offsets[host] = 0.0
        else:
            offsets[host] = _median([own[s] - ref[s] for s in shared])
    return offsets


def stream_host(records: Sequence[dict], default: int = 0) -> int:
    """The host that wrote a stream: the majority ``pid`` stamp over its
    records (``Telemetry.emit`` stamps every record with the writer)."""
    votes: Dict[int, int] = {}
    for rec in records:
        pid = rec.get("pid")
        if pid is not None:
            votes[int(pid)] = votes.get(int(pid), 0) + 1
    if not votes:
        return default
    return max(votes, key=lambda h: (votes[h], -h))


# a dispatch arrow binds to the first replica-side request begin at or
# after the router's dispatch instant; the slack absorbs same-host
# scheduling jitter between the router's send and the replica's accept
_DISPATCH_SLACK_S = 0.005


def request_journeys(
    merged: Sequence[dict],
) -> Tuple[List[dict], Dict[str, dict]]:
    """Per-trace journey flows from corrected ``req`` records.

    Groups records by ``trace_id``, then pairs the router's k-th
    ``dispatched`` begin with the earliest unconsumed replica-side
    ``request`` begin at ts >= dispatch − slack, emitting one
    ``s``/``f`` flow arrow per hop (named ``handoff`` when the dispatch
    was a journal-ownership resume, ``dispatch`` otherwise). Returns
    (flow events, per-trace table for ``progenTraces``). The router pid
    is wherever the ``dispatched`` phases live — replica begins on that
    pid are the router's own envelope, not a hop target."""
    per: Dict[str, dict] = {}
    for rec in merged:
        if rec.get("ev") != "req":
            continue
        tr = rec.get("trace_id")
        ts = rec.get("ts")
        if tr is None or ts is None:
            continue
        j = per.setdefault(str(tr), {
            "dispatches": [], "begins": [], "pids": set(), "sheds": 0,
        })
        j["pids"].add(int(rec.get("pid", 0)))
        name = rec.get("name")
        ph = rec.get("ph")
        if ph == "b" and name == "dispatched":
            j["dispatches"].append({
                "ts": float(ts), "pid": int(rec.get("pid", 0)),
                "resumed": bool(rec.get("resumed")),
            })
        elif ph == "b" and name == "request":
            j["begins"].append(
                {"ts": float(ts), "pid": int(rec.get("pid", 0))}
            )
        elif ph == "n" and name == "shed":
            j["sheds"] += 1

    flows: List[dict] = []
    table: Dict[str, dict] = {}
    for tr in sorted(per):
        j = per[tr]
        dispatches = sorted(j["dispatches"], key=lambda d: d["ts"])
        router_pid = dispatches[0]["pid"] if dispatches else None
        begins = sorted(
            (b for b in j["begins"] if b["pid"] != router_pid),
            key=lambda b: b["ts"],
        )
        used = [False] * len(begins)
        arrows = 0
        handoffs = 0
        for k, d in enumerate(dispatches):
            target = None
            for i, b in enumerate(begins):
                if not used[i] and b["ts"] >= d["ts"] - _DISPATCH_SLACK_S:
                    target = i
                    break
            if target is None:
                continue
            used[target] = True
            b = begins[target]
            name = "handoff" if d["resumed"] else "dispatch"
            fid = f"trace:{tr}:{k}"
            flows.append({
                "ph": "s", "cat": "request_flow", "name": name,
                "id": fid, "ts": d["ts"] * 1e6, "pid": d["pid"],
                "tid": 0,
            })
            flows.append({
                "ph": "f", "bp": "e", "cat": "request_flow",
                "name": name, "id": fid, "ts": b["ts"] * 1e6,
                "pid": b["pid"], "tid": 0,
            })
            arrows += 1
            if d["resumed"]:
                handoffs += 1
        table[tr] = {
            "pids": sorted(j["pids"]),
            "hops": len(dispatches),
            "handoffs": handoffs,
            "flows": arrows,
            "shed": j["sheds"] > 0,
        }
    return flows, table


def stitch_streams(
    event_streams: Sequence[Sequence[dict]],
    metrics_streams: Sequence[Tuple[int, Sequence[dict]]] = (),
    reference: int = 0,
    force_hosts: bool = False,
) -> dict:
    """Merge already-parsed per-host record streams into one trace dict.

    Each event stream keeps its file order (B/E pairing in build_trace
    is per-pid, so per-host order is all that matters); every record's
    ``ts`` is corrected by its writer's clock offset. ``goodput_host``
    records are deduped across streams (each host's own copy wins) so
    the fleet skew table counts every host exactly once.
    ``metrics_streams`` pairs each row set with the host it came from —
    metrics.jsonl rows carry no pid of their own. ``force_hosts``
    re-stamps stream ``i`` with pid ``i`` regardless of what the records
    say — the serving fleet is N processes on one host, all stamping
    pid 0, and the journey flow arrows need distinct tracks."""
    streams = [list(s) for s in event_streams]
    if force_hosts:
        streams = [
            [{**rec, "pid": i} for rec in stream]
            for i, stream in enumerate(streams)
        ]
    beacons = collect_beacons(r for s in streams for r in s)
    offsets = clock_offsets(beacons, reference=reference)

    def corrected(rec: dict) -> dict:
        off = offsets.get(int(rec.get("pid", 0)), 0.0)
        if off and rec.get("ts") is not None:
            return {**rec, "ts": float(rec["ts"]) - off}
        return rec

    merged: List[dict] = []
    goodput: Dict[int, dict] = {}
    for stream in streams:
        for rec in stream:
            ev = rec.get("ev")
            if ev == "clock_beacon":
                continue  # re-rendered below as anchor slices + flows
            if ev == "goodput_host" and "host" in rec:
                host = int(rec["host"])
                if (
                    host not in goodput
                    or int(rec.get("pid", -1)) == host
                ):
                    goodput[host] = corrected(rec)
                continue
            merged.append(corrected(rec))
    merged.extend(goodput[h] for h in sorted(goodput))

    metrics_merged: List[dict] = []
    for host, rows in metrics_streams:
        off = offsets.get(int(host), 0.0)
        for rec in rows:
            if rec.get("_time") is None:
                continue
            metrics_merged.append(
                {**rec, "pid": int(host), "_time": float(rec["_time"]) - off}
            )

    trace = build_trace(merged, metrics_merged)

    # beacon anchors + cross-host step_sync arrows on corrected clocks
    extra: List[dict] = []
    steps = sorted({s for per in beacons.values() for s in per})
    arrows = 0
    for step in steps:
        present = sorted(h for h, per in beacons.items() if step in per)
        t = {
            h: beacons[h][step] - offsets.get(h, 0.0) for h in present
        }
        ref = reference if reference in present else present[0]
        for h in present:
            extra.append({
                "ph": "X", "name": "clock_beacon", "cat": "beacon",
                "ts": t[h] * 1e6, "dur": _BEACON_DUR_US,
                "pid": h, "tid": 0,
                "args": {
                    "step": step,
                    "skew_ms": round((t[h] - t[ref]) * 1e3, 3),
                },
            })
        for h in present:
            if h == ref:
                continue
            fid = f"step{step}:{h}"
            mid = _BEACON_DUR_US / 2.0
            extra.append({
                "ph": "s", "cat": "step_flow", "name": "step_sync",
                "id": fid, "ts": t[ref] * 1e6 + mid, "pid": ref,
                "tid": 0,
            })
            extra.append({
                "ph": "f", "bp": "e", "cat": "step_flow",
                "name": "step_sync", "id": fid,
                "ts": t[h] * 1e6 + mid, "pid": h, "tid": 0,
            })
            arrows += 1

    journey_flows, journeys = request_journeys(merged)
    extra.extend(journey_flows)

    meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
    timed = [e for e in trace["traceEvents"] if e["ph"] != "M"] + extra
    timed.sort(key=lambda e: e["ts"])  # stable: file order at equal ts
    trace["traceEvents"] = meta + timed
    trace["progenClockOffsets"] = {
        str(h): round(off, 6) for h, off in sorted(offsets.items())
    }
    if journeys:
        trace["progenTraces"] = journeys
    trace["progenStitch"] = {
        "hosts": len(streams),
        "beacon_steps": len(steps),
        "flow_arrows": arrows,
        "request_flows": len(journey_flows) // 2,
    }
    return trace


def stitch_trace(
    event_paths: Sequence,
    out_path=None,
    metrics_paths: Sequence = (),
    reference: int = 0,
    force_hosts: bool = False,
) -> dict:
    """File-level stitch: read N hosts' events.jsonl (and optionally
    their metrics.jsonl, zipped positionally with ``event_paths``),
    merge onto the reference host's clock, optionally write the trace
    JSON, and return the trace dict. ``force_hosts`` assigns each file
    its argument position as its pid (serving fleets share a host, so
    every process stamps pid 0 — indistinguishable tracks otherwise)."""
    drops = LineDrops()
    # iter_events_any: a stream argument may be a flight-recorder dump
    # (flight-*.json) instead of events.jsonl — a SIGKILLed host's black
    # box stitches in as its own track next to the survivors
    streams = [list(iter_events_any(p, drops)) for p in event_paths]
    if force_hosts:
        hosts = list(range(len(streams)))
    else:
        hosts = [stream_host(s, i) for i, s in enumerate(streams)]
    metrics_streams: List[Tuple[int, List[dict]]] = []
    for host, mp in zip(hosts, metrics_paths or ()):
        if mp is not None and Path(mp).exists():
            metrics_streams.append((host, list(iter_jsonl(mp, drops))))
    trace = stitch_streams(
        streams, metrics_streams, reference=reference,
        force_hosts=force_hosts,
    )
    trace["progenDroppedLines"] = drops.count
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with out_path.open("w") as f:
            json.dump(trace, f)
    return trace
