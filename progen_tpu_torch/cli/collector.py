"""``progen-tpu-torch-collector`` — the fleet metrics scrape loop, the
port's copy of the JAX package's ``cli/collector.py`` (argparse in place
of click, with the same flags and output).

Point it at the exposition files the fleet already writes (replica and
router ``--prom_file`` textfiles, tracker ``metrics.jsonl`` streams)
and it ticks forever: scrape → stamp → append to the ring-buffer TSDB,
with staleness and fleet-SLO burn transitions fanned into an alerts
JSONL. Device-free — it is a sidecar, not a replica — so it starts in
milliseconds and can run on any host that sees the files.

Sources come from repeatable ``--source name=...,role=...,prom=...``
specs (the router's ``--replica`` syntax) or a flat TOML
(``configs/serving/collector.toml`` is the shipped example); flags
override config values.

Egress (all optional, all non-blocking for the scrape loop):
``--remote-write URL`` pushes the merged fleet series to a Prometheus
remote-write receiver (bounded spool, drops counted); ``--alert-config
TOML`` routes alert transitions through dedup/severity/silences to
webhook/file/stderr sinks with a ``notifications.jsonl`` ledger;
``--archive DIR`` ships sealed TSDB blocks verbatim (digest manifest)
before the ring degrades them. ``--flight-dir`` arms the collector's
flight recorder; ``--profile-pin`` asks a serve or train process for a
profiler window on the first fleet SLO ``burning`` edge.

Run: python -m progen_tpu_torch.cli.collector --tsdb D \\
         --source name=r0,role=replica,prom=r0/metrics.prom
"""

from __future__ import annotations

import argparse
import signal
import time

from progen_tpu_torch.cli import echo, existing_file
from progen_tpu_torch.telemetry import flight as flight_mod
from progen_tpu_torch.telemetry.alert_router import (
    AlertRouter,
    load_router_config,
)
from progen_tpu_torch.telemetry.alerts import AlertSink
from progen_tpu_torch.telemetry.collector import (
    Collector,
    load_collector_config,
    parse_source_spec,
)
from progen_tpu_torch.telemetry.remote_write import RemoteWriteBridge
from progen_tpu_torch.telemetry.slo import load_objectives
from progen_tpu_torch.telemetry.tsdb import BlockShipper, RingTSDB


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.collector", allow_abbrev=False,
        description="Scrape fleet metrics sources into a bounded TSDB + "
                    "alert sink.")
    p.add_argument("--tsdb", dest="tsdb_dir", required=True,
                   help="ring-buffer store directory (created if missing; "
                        "one collector per directory)")
    p.add_argument("--source", dest="source_specs", action="append",
                   default=[],
                   help="scrape target: name=r0,role=replica,prom=/path/"
                        "metrics.prom[,metrics=/path/metrics.jsonl] — "
                        "repeatable")
    p.add_argument("--config", dest="config_path", type=existing_file,
                   default=None,
                   help="flat TOML with [collector] settings and "
                        "[source_<name>] tables (flags override)")
    p.add_argument("--interval", type=float, default=None,
                   help="seconds between scrapes [default: 2]")
    p.add_argument("--stale-after", dest="stale_after", type=float,
                   default=None,
                   help="exposition age (s) past which a source counts as "
                        "down [default: 10]")
    p.add_argument("--budget-bytes", dest="budget_bytes", type=int,
                   default=None,
                   help="TSDB ring byte budget; over it, old blocks "
                        "downsample then drop [default: 8 MiB]")
    p.add_argument("--block-bytes", dest="block_bytes", type=int,
                   default=None,
                   help="TSDB block size before seal-and-rotate "
                        "[default: 256 KiB]")
    p.add_argument("--slo", dest="slo_path", type=existing_file, default=None,
                   help="objectives TOML: evaluate fleet SLOs each tick "
                        "and alert on burn transitions")
    p.add_argument("--alerts-out", dest="alerts_out", default=None,
                   help="alerts JSONL path [default: <tsdb>/alerts.jsonl]")
    p.add_argument("--remote-write", dest="remote_write_url", default=None,
                   help="push the merged fleet series to this HTTP "
                        "endpoint (Prometheus remote-write, JSON body; "
                        "bounded spool, never blocks the scrape loop)")
    p.add_argument("--alert-config", dest="alert_config_path",
                   type=existing_file, default=None,
                   help="alert router TOML ([alert_router] + "
                        "[route_<name>] tables)")
    p.add_argument("--archive", dest="archive_dir", default=None,
                   help="ship sealed TSDB blocks verbatim to this "
                        "directory (digest manifest) before the ring "
                        "downsamples or drops them")
    p.add_argument("--flight-dir", dest="flight_dir", default=None,
                   help="arm the collector's flight recorder: bounded ring "
                        "of recent scrape/SLO telemetry, dumped atomically "
                        "here on crash paths and on fleet SLO 'burning' "
                        "edges")
    p.add_argument("--profile-pin", dest="profile_pins", action="append",
                   default=[],
                   help="on the first fleet SLO 'burning' edge, request an "
                        "on-demand torch.profiler window by writing this "
                        "control file (a serve/train --profile_pin path) — "
                        "repeatable, rate-limited")
    p.add_argument("--profile-min-interval", dest="profile_min_interval",
                   type=float, default=300.0,
                   help="seconds between auto-requested profile windows "
                        "(per collector, across all pins) [default: 300]")
    p.add_argument("--max-ticks", dest="max_ticks", type=int, default=0,
                   help="stop after N scrapes (0 = run until "
                        "SIGTERM/SIGINT)")
    p.add_argument("--once", action="store_true",
                   help="single scrape, then exit (CI probes)")
    return p


def collect(
    parser, tsdb_dir, source_specs, config_path, interval, stale_after,
    budget_bytes, block_bytes, slo_path, alerts_out,
    remote_write_url, alert_config_path, archive_dir,
    flight_dir, profile_pins, profile_min_interval,
    max_ticks, once,
) -> int:
    """Scrape fleet metrics sources into a bounded TSDB + alert sink."""
    settings = {}
    sources = []
    if config_path is not None:
        settings, sources = load_collector_config(config_path)
    try:
        sources += [parse_source_spec(s) for s in source_specs]
    except ValueError as e:
        parser.error(str(e))
    if not sources:
        parser.error("no sources: pass --source and/or --config")
    interval = float(
        interval if interval is not None
        else settings.get("interval_s", 2.0)
    )
    stale_after = float(
        stale_after if stale_after is not None
        else settings.get("stale_after_s", 10.0)
    )
    budget_bytes = int(
        budget_bytes if budget_bytes is not None
        else settings.get("budget_bytes", 8 << 20)
    )
    block_bytes = int(
        block_bytes if block_bytes is not None
        else settings.get("block_bytes", 256 << 10)
    )
    if slo_path is None:
        slo_path = settings.get("slo") or None
    cfg = load_objectives(slo_path) if slo_path else None

    shipper = (
        BlockShipper(archive_dir) if archive_dir is not None else None
    )
    tsdb = RingTSDB(
        tsdb_dir, budget_bytes=budget_bytes, block_bytes=block_bytes,
        shipper=shipper,
    )
    alerts_path = (
        alerts_out if alerts_out is not None
        else tsdb.root / "alerts.jsonl"
    )
    router = None
    if alert_config_path is not None:
        severity, routes = load_router_config(alert_config_path)
        router = AlertRouter(
            tsdb.root / "notifications.jsonl", routes,
            severity=severity,
        )
    alerts = AlertSink(
        alerts_path,
        relay=router.handle if router is not None else None,
    )
    bridge = (
        RemoteWriteBridge(remote_write_url)
        if remote_write_url else None
    )
    coll = Collector(
        tsdb, sources, stale_after_s=stale_after,
        slo_cfg=cfg, alerts=alerts, remote_write=bridge,
        profile_pins=profile_pins,
        profile_min_interval_s=profile_min_interval,
    )
    if flight_dir:
        flight_mod.arm(flight_dir)
    echo(
        f"collector: {len(sources)} sources -> {tsdb.root} "
        f"(every {interval:g}s, stale after {stale_after:g}s, "
        f"budget {budget_bytes} B"
        + (", fleet SLOs on" if cfg else "")
        + (f", remote-write {remote_write_url}" if bridge else "")
        + (f", {len(router.routes)} alert routes" if router else "")
        + (f", archive {archive_dir}" if shipper else "")
        + (f", flight {flight_dir}" if flight_dir else "")
        + (f", auto-profile x{len(profile_pins)}"
           if profile_pins else "")
        + ")",
        err=True,
    )

    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    ticks = 0
    try:
        while not stop["flag"]:
            coll.scrape_once()
            if router is not None:
                router.tick()  # fire any due escalation chains
            ticks += 1
            if once or (max_ticks and ticks >= max_ticks):
                break
            deadline = time.time() + interval
            while not stop["flag"] and time.time() < deadline:
                time.sleep(min(0.2, interval))
    finally:
        flight_mod.disarm()
        tsdb.close()
        alerts.close()
        if router is not None:
            router.close()
    tail = ""
    if bridge is not None:
        s = bridge.stats()
        tail += (
            f", remote-write {s['sent_points']} pts sent "
            f"({s['dropped_points']} dropped, "
            f"{s['push_failures']} push failures)"
        )
    if router is not None:
        tail += (
            f", notify {router.counts['sent']} sent / "
            f"{router.counts['silenced']} silenced / "
            f"{router.counts['deduped']} deduped / "
            f"{router.counts['escalated']} escalated"
        )
    if shipper is not None:
        tail += (
            f", archive {shipper.shipped} shipped / "
            f"{shipper.skipped} skipped / "
            f"{shipper.verify_failed} verify-failed"
        )
    echo(
        f"collector: {ticks} ticks, {len(tsdb.blocks())} blocks, "
        f"{tsdb.total_bytes()} bytes, "
        f"{tsdb.dropped_lines} torn lines dropped" + tail,
        err=True,
    )
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    return collect(parser, **vars(parser.parse_args(argv)))


if __name__ == "__main__":
    raise SystemExit(main())
