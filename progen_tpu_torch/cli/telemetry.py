"""Run-analysis CLI over the telemetry event stream, the port's copy of
the JAX package's ``cli/telemetry.py`` (argparse in place of click, with
the same subcommands, flags and output).

Host-side tooling — no device, no config: it reads the ``events.jsonl``
(and optionally ``metrics.jsonl``) any train, serve or router run leaves
behind and turns them into the artifacts a post-mortem wants:

  * ``export-trace`` — Chrome Trace Event / Perfetto JSON: span slices
    per host/thread, instant markers for retries/anomalies/stalls/chaos,
    counter tracks for step_ms, MFU, goodput buckets and device memory.
  * ``summarize`` — terminal report: per-host goodput table with the
    cross-host skew, per-span-name p50/p95/p99 latency, serving
    request-phase + TTFT/ITL latency quantiles, resilience event counts.
  * ``stitch`` — N processes' events.jsonl → ONE fleet trace on a common
    corrected clock (clock_beacon-anchored skew correction, cross-host
    step flow arrows). ``--force-hosts`` gives each input file its own
    process track and draws the per-request journeys router → replica.
  * ``query`` — one request's timeline across events, flight dumps,
    journals, the collector's TSDB and the alert ledgers.
  * ``slo-report`` — the fleet SLO gate: objectives from TOML, burn rates
    over metrics.jsonl / Prometheus textfiles / a collector TSDB, exit 0
    (ok) / 1 (warn) / 2 (burning), ``--watch`` for a live loop.

Every reader reports how many torn/garbage input lines it had to skip.

Run: python -m progen_tpu_torch.cli.telemetry export-trace events.jsonl
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from progen_tpu_torch.cli import echo, existing_dir, existing_file
from progen_tpu_torch.telemetry import slo as slo_mod
from progen_tpu_torch.telemetry.goodput import goodput_skew
from progen_tpu_torch.telemetry.registry import _Timing
from progen_tpu_torch.telemetry.stitch import stitch_trace
from progen_tpu_torch.telemetry.trace import (
    INSTANT_EVENTS,
    LineDrops,
    export_trace,
    iter_jsonl,
)


def _echo_drops(n: int) -> None:
    if n:
        echo(
            f"WARNING: skipped {n} torn/garbage line"
            f"{'s' if n != 1 else ''} in the input stream(s)"
        )


def export_trace_cmd(events, metrics, out):
    """Convert EVENTS (events.jsonl) to Perfetto trace-event JSON."""
    events = Path(events)
    if metrics is None:
        sibling = events.with_name("metrics.jsonl")
        metrics = str(sibling) if sibling.exists() else None
    if out is None:
        out = str(events.with_name("trace.json"))
    trace = export_trace(events, out, metrics_path=metrics)
    n = len(trace["traceEvents"])
    echo(f"wrote {out} ({n} trace events)")
    _echo_drops(trace.get("progenDroppedLines", 0))
    echo("open at https://ui.perfetto.dev or chrome://tracing")


def stitch_cmd(events, metrics_paths, out, reference, force_hosts):
    """Merge N hosts' EVENTS files into ONE clock-aligned fleet trace.

    Per-host clock skew is corrected from the clock_beacon records the
    train loop emits at step boundaries (median beacon delta vs the
    reference host); cross-host step_sync flow arrows link each step's
    beacons so a straggler renders as an arrow fan. Request records
    carrying a trace_id are additionally linked into per-request
    journeys (dispatch/handoff flow arrows router → replica) and
    tabulated under the trace's progenTraces key."""
    if out is None:
        out = str(Path(events[0]).with_name("stitched_trace.json"))
    trace = stitch_trace(
        list(events), out_path=out,
        metrics_paths=list(metrics_paths), reference=reference,
        force_hosts=force_hosts,
    )
    info = trace.get("progenStitch", {})
    offsets = trace.get("progenClockOffsets", {})
    echo(
        f"wrote {out} ({len(trace['traceEvents'])} trace events from "
        f"{info.get('hosts', len(events))} host streams)"
    )
    if offsets:
        for h in sorted(offsets, key=int):
            echo(
                f"  host {h}: clock offset "
                f"{float(offsets[h]) * 1e3:+.3f} ms vs host {reference}"
            )
        echo(
            f"  {info.get('beacon_steps', 0)} beacon steps, "
            f"{info.get('flow_arrows', 0)} cross-host step arrows"
        )
    else:
        echo(
            "  no clock_beacon records found — streams merged on raw "
            "(uncorrected) host clocks"
        )
    journeys = trace.get("progenTraces", {})
    if journeys:
        handoffs = sum(j.get("handoffs", 0) for j in journeys.values())
        echo(
            f"  {len(journeys)} request journeys, "
            f"{info.get('request_flows', 0)} dispatch/handoff arrows"
            + (f" ({handoffs} handoffs)" if handoffs else "")
        )
    _echo_drops(trace.get("progenDroppedLines", 0))
    echo("open at https://ui.perfetto.dev or chrome://tracing")


def _host_reports(events_path, metrics_path, drops=None) -> list:
    """Latest per-host goodput reports. Primary source: the
    ``goodput_host`` records every host emits at end of run. Fallback
    for runs predating per-host emission: the last metrics.jsonl row
    carrying ``goodput_pct`` becomes host 0's report."""
    by_host: dict = {}
    for rec in iter_jsonl(events_path, drops):
        if rec.get("ev") == "goodput_host" and "host" in rec:
            by_host[int(rec["host"])] = {
                k: v for k, v in rec.items()
                if k not in ("ev", "ts", "host", "pid")
            }
    if by_host:
        return [by_host[h] for h in sorted(by_host)]
    if metrics_path is not None and Path(metrics_path).exists():
        last = None
        for rec in iter_jsonl(metrics_path, drops):
            if "goodput_pct" in rec:
                last = rec
        if last is not None:
            return [{
                k: v for k, v in last.items()
                if k == "goodput_pct" or k.startswith("bucket_s/")
                or k == "wall_s"
            }]
    return []


def summarize_cmd(events, metrics, top_spans, top_traces, slo_path):
    """Per-host goodput + skew, span latency quantiles, request
    journeys, SLO burn rates, event counts."""
    events = Path(events)
    if metrics is None:
        sibling = events.with_name("metrics.jsonl")
        metrics = str(sibling) if sibling.exists() else None

    # each input file is drop-counted exactly once (the goodput-report
    # pass below re-reads the same files, so it is left uncounted)
    drops = LineDrops()
    reports = _host_reports(events, metrics)
    if reports:
        echo("== goodput (per host) ==")
        buckets = sorted(
            {k for rep in reports for k in rep if k.startswith("bucket_s/")}
        )
        header = f"{'host':>4} {'wall_s':>9} {'goodput%':>9}"
        for b in buckets:
            header += f" {b.split('/', 1)[1]:>11}"
        echo(header)
        for i, rep in enumerate(reports):
            line = (
                f"{i:>4} {rep.get('wall_s', 0.0):>9.2f} "
                f"{rep.get('goodput_pct', 0.0):>9.2f}"
            )
            for b in buckets:
                line += f" {float(rep.get(b, 0.0)):>11.3f}"
            echo(line)
        if len(reports) > 1:
            echo("")
            echo("== cross-host skew (straggler table) ==")
            skew = goodput_skew(reports)
            echo(
                f"{'bucket':<14} {'min':>10} {'max':>10} {'skew':>10}"
            )
            for name, row in skew.items():
                if not isinstance(row, dict):
                    continue
                echo(
                    f"{name:<14} {row['min']:>10.3f} {row['max']:>10.3f} "
                    f"{row['skew']:>10.3f}  straggler host "
                    f"{row['straggler']}"
                )
        echo("")

    timings: dict = {}
    counts: dict = {}
    open_req: dict = {}
    routes: list = []
    journeys: dict = {}
    for rec in iter_jsonl(events, drops):
        ev = rec.get("ev")
        if ev == "E" and "dur_s" in rec:
            timings.setdefault(
                str(rec.get("span", "?")), _Timing()
            ).observe(float(rec["dur_s"]))
        elif ev == "req":
            # request lifecycle phases: pair b/e per (request, phase)
            # into req/<phase> timing families in the span table
            ph, rid, name = rec.get("ph"), rec.get("req"), rec.get("name")
            if ph == "b":
                open_req[(rid, name)] = rec.get("ts")
            elif ph == "e":
                t0 = open_req.pop((rid, name), None)
                if t0 is not None and rec.get("ts") is not None:
                    timings.setdefault(
                        f"req/{name}", _Timing()
                    ).observe(float(rec["ts"]) - float(t0))
            # trace_id-carrying records fold into per-request journeys
            tr, ts = rec.get("trace_id"), rec.get("ts")
            if tr is not None and ts is not None:
                j = journeys.setdefault(str(tr), {
                    "t0": float(ts), "t1": float(ts), "hops": 0,
                    "handoffs": 0, "shed": False, "reqs": set(),
                })
                j["t0"] = min(j["t0"], float(ts))
                j["t1"] = max(j["t1"], float(ts))
                if rid is not None:
                    j["reqs"].add(str(rid))
                if ph == "b" and name == "dispatched":
                    j["hops"] += 1
                    if rec.get("resumed"):
                        j["handoffs"] += 1
                elif ph == "n" and name == "shed":
                    j["shed"] = True
        elif ev not in ("B", "E", None):
            counts[str(ev)] = counts.get(str(ev), 0) + 1
            if ev == "route":
                routes.append(rec)

    if timings:
        echo("== span latency (s) ==")
        echo(
            f"{'span':<28} {'count':>6} {'p50':>9} {'p95':>9} "
            f"{'p99':>9} {'total':>9}"
        )
        families = sorted(
            timings.items(), key=lambda kv: kv[1].sum, reverse=True
        )
        for name, t in families[:top_spans]:
            echo(
                f"{name:<28} {t.count:>6} {t.quantile(0.5):>9.4f} "
                f"{t.quantile(0.95):>9.4f} {t.quantile(0.99):>9.4f} "
                f"{t.sum:>9.3f}"
            )
        if len(families) > top_spans:
            echo(f"... {len(families) - top_spans} more (--spans)")
        echo("")

    if routes:
        # the router's routing-decision records (serving/router.py):
        # one per dispatch/handoff/shed/replica-death, replica-attributed
        per: dict = {}

        def _row(i):
            return per.setdefault(int(i), {
                "routed": 0, "retried": 0, "handoff_in": 0,
                "handoff_out": 0, "shed": 0, "down": 0,
            })

        shed_router = 0
        for r in routes:
            st = r.get("status")
            if st == "dispatched" and r.get("replica") is not None:
                _row(r["replica"])["routed"] += 1
                if r.get("retry"):
                    _row(r["replica"])["retried"] += 1
            elif st == "handoff":
                if r.get("from") is not None:
                    _row(r["from"])["handoff_out"] += 1
                if r.get("to") is not None:
                    _row(r["to"])["handoff_in"] += 1
            elif st == "shed":
                if r.get("replica") is not None:
                    _row(r["replica"])["shed"] += 1
                else:
                    shed_router += 1  # shed before any replica owned it
            elif st == "replica_down" and r.get("replica") is not None:
                _row(r["replica"])["down"] += 1
        echo("== router (per replica) ==")
        echo(
            f"{'replica':>7} {'routed':>7} {'retried':>8} "
            f"{'handoff_in':>11} {'handoff_out':>12} {'shed':>5} "
            f"{'down':>5}"
        )
        for i in sorted(per):
            p = per[i]
            echo(
                f"{i:>7} {p['routed']:>7} {p['retried']:>8} "
                f"{p['handoff_in']:>11} {p['handoff_out']:>12} "
                f"{p['shed']:>5} {p['down']:>5}"
            )
        if shed_router:
            echo(f"shed at the router (no replica): {shed_router}")
        echo("")

    if journeys:
        # per-request journeys: every req record carrying the router's
        # trace_id, longest (slowest end-to-end) first
        echo("== request journeys (by trace_id) ==")
        echo(
            f"{'trace':<18} {'span_s':>8} {'hops':>5} {'handoffs':>9} "
            f"{'shed':>5}"
        )
        rows = sorted(
            journeys.items(), key=lambda kv: kv[1]["t1"] - kv[1]["t0"],
            reverse=True,
        )
        for tr, j in rows[:top_traces]:
            echo(
                f"{tr:<18} {j['t1'] - j['t0']:>8.3f} {j['hops']:>5} "
                f"{j['handoffs']:>9} {'yes' if j['shed'] else '-':>5}"
            )
        if len(rows) > top_traces:
            echo(f"... {len(rows) - top_traces} more (--traces)")
        echo("")

    serve_row = None
    router_row = None
    if metrics is not None and Path(metrics).exists():
        for rec in iter_jsonl(metrics, drops):
            if any(k.startswith("serve/") for k in rec):
                serve_row = rec  # last snapshot wins (cumulative)
            if any(k.startswith("router/") for k in rec):
                router_row = rec
    if router_row is not None:
        echo("== fleet request latency (s) ==")
        echo(
            f"{'metric':<12} {'count':>6} {'p50':>9} {'p95':>9} {'p99':>9}"
        )
        for fam in ("ttft_s", "latency_s"):
            if f"router/{fam}_count" not in router_row:
                continue
            echo(
                f"{fam:<12} "
                f"{int(router_row[f'router/{fam}_count']):>6} "
                f"{router_row.get(f'router/{fam}_p50_s', 0.0):>9.4f} "
                f"{router_row.get(f'router/{fam}_p95_s', 0.0):>9.4f} "
                f"{router_row.get(f'router/{fam}_p99_s', 0.0):>9.4f}"
            )
        echo("")
    if serve_row is not None:
        echo("== serving latency (s) ==")
        echo(
            f"{'metric':<12} {'count':>6} {'p50':>9} {'p95':>9} {'p99':>9}"
        )
        for fam in ("ttft_s", "itl_s", "latency_s"):
            if f"serve/{fam}_count" not in serve_row:
                continue
            echo(
                f"{fam:<12} "
                f"{int(serve_row[f'serve/{fam}_count']):>6} "
                f"{serve_row.get(f'serve/{fam}_p50_s', 0.0):>9.4f} "
                f"{serve_row.get(f'serve/{fam}_p95_s', 0.0):>9.4f} "
                f"{serve_row.get(f'serve/{fam}_p99_s', 0.0):>9.4f}"
            )
        echo("")

    if slo_path is not None:
        cfg = slo_mod.load_objectives(slo_path)
        series = []
        if metrics is not None and Path(metrics).exists():
            series.append(slo_mod.samples_from_metrics(
                iter_jsonl(metrics, drops)
            ))
        echo("== SLOs ==")
        echo(
            slo_mod.render_report(cfg, slo_mod.evaluate(cfg, series))
        )
        echo("")

    if counts:
        echo("== events ==")
        order = [e for e in INSTANT_EVENTS if e in counts]
        order += sorted(set(counts) - set(order))
        for ev in order:
            echo(f"{ev:<24} {counts[ev]:>6}")
    _echo_drops(drops.count)


def query_cmd(trace_id, events_paths, journal_paths, tsdb_dir,
              notify_paths, log_dirs, json_out):
    """Reconstruct one request's journey across every evidence stream.

    Joins events.jsonl streams, flight-recorder dumps, serving
    journals, collector TSDB exemplars and alert/notification ledgers
    on a single trace_id and prints the merged chronological timeline —
    a request that died with its replica still reads contiguously:
    router intake -> dispatch -> the dead replica's journaled tokens
    (from its flight dump) -> handoff -> the survivor's completion.
    Exits 1 when the trace appears nowhere."""
    from progen_tpu_torch.telemetry import flight

    events = [Path(p) for p in events_paths]
    journals = [Path(p) for p in journal_paths]
    notifies = [Path(p) for p in notify_paths]
    for d in log_dirs:
        root = Path(d)
        events += sorted(root.rglob("events.jsonl"))
        events += flight.find_dumps(root)
        journals += sorted(root.rglob("journal*.jsonl"))
        for name in ("alerts.jsonl", "notifications.jsonl"):
            notifies += sorted(root.rglob(name))
    # a file named both explicitly and via --logs must join only once
    events = list(dict.fromkeys(p.resolve() for p in events))
    journals = list(dict.fromkeys(p.resolve() for p in journals))
    notifies = list(dict.fromkeys(p.resolve() for p in notifies))
    drops = LineDrops()
    timeline = flight.trace_timeline(
        trace_id,
        events=events,
        journals=journals,
        tsdb_dir=tsdb_dir,
        extra_jsonl=notifies,
        drops=drops,
    )
    if json_out is not None:
        Path(json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(json_out).write_text(json.dumps(
            {"trace_id": str(trace_id), "timeline": timeline},
            indent=2, default=str,
        ))
    if not timeline:
        echo(f"trace {trace_id}: no records found")
        _echo_drops(drops.count)
        return 1
    t0 = timeline[0]["ts"]
    echo(
        f"trace {trace_id}: {len(timeline)} records across "
        f"{len({e['src'] for e in timeline})} streams, "
        f"{timeline[-1]['ts'] - t0:.3f}s end to end"
    )
    for e in timeline:
        stamp = time.strftime("%H:%M:%S", time.localtime(e["ts"]))
        echo(
            f"  {stamp} +{e['ts'] - t0:>8.3f}s "
            f"{e['src']:<24} {e['what']}"
        )
    _echo_drops(drops.count)


_DEFAULT_OBJECTIVES = (
    Path(__file__).resolve().parents[2] / "configs" / "serving"
    / "slo.toml"
)


def slo_report_cmd(
    objectives, metrics_paths, prom_paths, tsdb_dir, events_out,
    json_out, watch_s, max_ticks,
):
    """Judge the fleet's SLOs and exit 0 (ok) / 1 (warn) / 2 (burning).

    Report mode (no --watch) is deterministic over archived artifacts:
    "now" is the newest metrics sample, so re-running the gate on the
    same files always yields the same verdict. --watch re-reads the
    sources every tick on the wall clock and emits ev:"slo" transition
    records (to --events-out, or the process telemetry sink)."""
    cfg = slo_mod.load_objectives(
        objectives if objectives is not None else _DEFAULT_OBJECTIVES
    )
    drops = LineDrops()

    def _gather():
        series = [
            slo_mod.samples_from_metrics(iter_jsonl(mp, drops))
            for mp in metrics_paths
        ]
        if tsdb_dir is not None:
            from progen_tpu_torch.telemetry.collector import fleet_series
            from progen_tpu_torch.telemetry.tsdb import TsdbReader

            fleet = fleet_series(TsdbReader(tsdb_dir).read(drops))
            series.append(fleet)
            if fleet:
                echo(
                    f"fleet series: {len(fleet)} ticks from {tsdb_dir}",
                    err=True,
                )
            else:
                echo(
                    f"WARNING: no samples in tsdb {tsdb_dir}", err=True
                )
        proms = []
        for pp in prom_paths:
            got = slo_mod.read_prom_file(pp)
            if got is None:
                echo(f"WARNING: prom file missing: {pp}", err=True)
            else:
                proms.append(got)
        return series, proms

    sink = None
    watch = None
    if events_out is not None:
        from progen_tpu_torch.telemetry.spans import EventLog

        sink = EventLog(events_out)
        watch = slo_mod.SloWatch(cfg, emit=sink.emit)

    if watch_s is None:
        series, proms = _gather()
        results = slo_mod.evaluate(cfg, series, proms)
        if watch is not None:
            watch.observe(results)
    else:
        ticks = 0
        results = []
        if watch is None:
            watch = slo_mod.SloWatch(cfg)  # process telemetry sink
        while True:
            series, proms = _gather()
            results = slo_mod.evaluate(
                cfg, series, proms, now=time.time()
            )
            for rec in watch.observe(results):
                echo(
                    f"slo transition: {rec['objective']} "
                    f"{rec['prev']} -> {rec['state']}"
                )
            ticks += 1
            if max_ticks and ticks >= max_ticks:
                break
            time.sleep(max(0.0, watch_s))

    echo(slo_mod.render_report(cfg, results))
    _echo_drops(drops.count)
    if json_out is not None:
        payload = slo_mod.results_payload(results)
        Path(json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(json_out).write_text(json.dumps(payload, indent=2))
    if sink is not None:
        sink.close()
    return slo_mod.exit_code(results)



def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.telemetry", allow_abbrev=False,
        description="Analyze telemetry event streams (events.jsonl).")
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser(
        "export-trace", allow_abbrev=False,
        help="convert EVENTS (events.jsonl) to Perfetto trace-event JSON")
    e.add_argument("events", type=existing_file)
    e.add_argument("--metrics", default=None,
                   help="metrics.jsonl for perf counter tracks (default: "
                        "sibling of EVENTS when present)")
    e.add_argument("--out", default=None,
                   help="output trace path (default: trace.json beside "
                        "EVENTS)")
    e.set_defaults(fn=export_trace_cmd)

    s = sub.add_parser(
        "stitch", allow_abbrev=False,
        help="merge N hosts' EVENTS files into ONE clock-aligned fleet "
             "trace")
    s.add_argument("events", nargs="+", type=existing_file)
    s.add_argument("--metrics", dest="metrics_paths", action="append",
                   default=[], type=existing_file,
                   help="per-host metrics.jsonl, repeatable; zipped "
                        "positionally with the EVENTS arguments")
    s.add_argument("--out", default=None,
                   help="output trace path (default: stitched_trace.json "
                        "beside the first EVENTS file)")
    s.add_argument("--reference", type=int, default=0,
                   help="host whose clock the fleet is corrected onto")
    s.add_argument("--force-hosts", dest="force_hosts",
                   action="store_true",
                   help="assign each EVENTS file its argument position as "
                        "its process track (serving fleets all stamp host "
                        "0; distinct tracks are required for per-request "
                        "journey flows)")
    s.set_defaults(fn=stitch_cmd)

    m = sub.add_parser(
        "summarize", allow_abbrev=False,
        help="per-host goodput + skew, span latency quantiles, request "
             "journeys, SLO burn rates, event counts")
    m.add_argument("events", type=existing_file)
    m.add_argument("--metrics", default=None,
                   help="metrics.jsonl (default: sibling of EVENTS when "
                        "present)")
    m.add_argument("--spans", dest="top_spans", type=int, default=20,
                   help="max span families in the latency table")
    m.add_argument("--traces", dest="top_traces", type=int, default=10,
                   help="max rows in the per-trace request journey table")
    m.add_argument("--slo", dest="slo_path", type=existing_file,
                   default=None,
                   help="SLO objectives TOML — adds a burn-rate section "
                        "judged over the metrics stream")
    m.set_defaults(fn=summarize_cmd)

    q = sub.add_parser(
        "query", allow_abbrev=False,
        help="reconstruct one request's journey across every evidence "
             "stream (exit 1 when the trace appears nowhere)")
    q.add_argument("--trace", dest="trace_id", required=True,
                   help="the trace_id to reconstruct (router intake mints "
                        "these)")
    q.add_argument("--events", dest="events_paths", action="append",
                   default=[], type=existing_file,
                   help="events.jsonl OR flight-*.json dump, repeatable")
    q.add_argument("--journal", dest="journal_paths", action="append",
                   default=[], type=existing_file,
                   help="serving journal.jsonl, repeatable")
    q.add_argument("--tsdb", dest="tsdb_dir", default=None,
                   help="collector TSDB: samples whose exemplars name "
                        "the trace")
    q.add_argument("--notifications", dest="notify_paths",
                   action="append", default=[], type=existing_file,
                   help="alerts.jsonl / notifications.jsonl, repeatable")
    q.add_argument("--logs", dest="log_dirs", action="append", default=[],
                   type=existing_dir,
                   help="directory to auto-discover evidence under "
                        "(recursive)")
    q.add_argument("--json", dest="json_out", default=None,
                   help="also write the timeline as JSON")
    q.set_defaults(fn=query_cmd)

    r = sub.add_parser(
        "slo-report", allow_abbrev=False,
        help="judge the fleet's SLOs and exit 0 (ok) / 1 (warn) / 2 "
             "(burning)")
    r.add_argument("--objectives", type=existing_file, default=None,
                   help="SLO TOML (default: the repo's "
                        "configs/serving/slo.toml)")
    r.add_argument("--metrics", dest="metrics_paths", action="append",
                   default=[], type=existing_file,
                   help="metrics.jsonl time series, repeatable")
    r.add_argument("--prom", dest="prom_paths", action="append",
                   default=[],
                   help="Prometheus exposition textfile, repeatable")
    r.add_argument("--tsdb", dest="tsdb_dir", default=None,
                   help="collector TSDB directory: evaluate the fleet-"
                        "aggregated series")
    r.add_argument("--events-out", dest="events_out", default=None,
                   help="append ev:slo state-transition records to this "
                        "events.jsonl")
    r.add_argument("--json", dest="json_out", default=None,
                   help="also write the full results as JSON")
    r.add_argument("--watch", dest="watch_s", type=float, default=None,
                   help="live mode: re-evaluate every N seconds on the "
                        "wall clock")
    r.add_argument("--max-ticks", dest="max_ticks", type=int, default=0,
                   help="stop --watch after N evaluations (0 = run until "
                        "killed)")
    r.set_defaults(fn=slo_report_cmd)
    return p


def main(argv=None) -> int:
    args = vars(build_parser().parse_args(argv))
    del args["command"]
    fn = args.pop("fn")
    return int(fn(**args) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
