"""``progen-tpu-torch-top`` — live fleet ops console over a collector
TSDB, the port's copy of the JAX package's ``cli/top.py`` (argparse in
place of click, with the same flags and output).

Opens the store READ-ONLY (never races the collector) and renders the
``console.build_snapshot`` view: per-source up/age/slots/queue/latency
rows, the fleet rollup, SLO burn states, recent alerts (annotated with
routed/silenced delivery state when an alert-router ledger exists), a
notifications tail with delivery counts, and the TSDB's own health
line. ``--alerts-only`` drops the source/fleet tables for an on-call
terminal.

Keys (watch mode): ``q`` quits; any other key refreshes immediately.
``--once`` renders a single frame; ``--once --json`` dumps the exact
snapshot dict as JSON — the scripting surface. ``--frames N`` stops watch
mode after N frames, which renders headless too.

Run: python -m progen_tpu_torch.cli.top --tsdb D --once
"""

from __future__ import annotations

import argparse
import sys

from progen_tpu_torch.cli import existing_dir, existing_file
from progen_tpu_torch.telemetry import console as console_mod
from progen_tpu_torch.telemetry.slo import load_objectives
from progen_tpu_torch.telemetry.tsdb import TsdbReader


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.top", allow_abbrev=False,
        description="Live ANSI dashboard (or one-shot JSON) for the "
                    "metrics fleet.")
    p.add_argument("--tsdb", dest="tsdb_dir", required=True, type=existing_dir,
                   help="collector store directory to watch")
    p.add_argument("--slo", dest="slo_path", type=existing_file, default=None,
                   help="objectives TOML: show fleet SLO states in the "
                        "dashboard")
    p.add_argument("--alerts", dest="alerts_path", default=None,
                   help="alerts JSONL [default: <tsdb>/alerts.jsonl when "
                        "present]")
    p.add_argument("--refresh", type=float, default=2.0,
                   help="seconds between frames in watch mode "
                        "[default: 2.0]")
    p.add_argument("--frames", type=int, default=0,
                   help="stop watch mode after N frames (0 = until "
                        "q/killed)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--json", dest="json_out", action="store_true",
                   help="with --once: print the snapshot as JSON instead "
                        "of ANSI")
    p.add_argument("--notifications", dest="notifications_path",
                   default=None,
                   help="alert-router ledger [default: <tsdb>/"
                        "notifications.jsonl when present]")
    p.add_argument("--alerts-only", dest="alerts_only", action="store_true",
                   help="render only the SLO/alert/notification panes "
                        "(on-call view)")
    p.add_argument("--color", dest="color", action="store_true",
                   default=None,
                   help="force ANSI color on [default: on for TTYs]")
    p.add_argument("--no-color", dest="color", action="store_false",
                   help="force ANSI color off")
    return p


def main(argv=None) -> int:
    """Live ANSI dashboard (or one-shot JSON) for the metrics fleet."""
    parser = build_parser()
    args = parser.parse_args(argv)
    tsdb = TsdbReader(args.tsdb_dir)
    cfg = load_objectives(args.slo_path) if args.slo_path else None
    alerts_path = args.alerts_path
    if alerts_path is None:
        default_alerts = tsdb.root / "alerts.jsonl"
        alerts_path = default_alerts if default_alerts.exists() else None
    notifications_path = args.notifications_path
    if notifications_path is None:
        default_notes = tsdb.root / "notifications.jsonl"
        notifications_path = (
            default_notes if default_notes.exists() else None
        )
    color = args.color
    if color is None:
        color = sys.stdout.isatty()
    if args.json_out and not args.once:
        parser.error("--json requires --once")
    if args.once:
        snap = console_mod.build_snapshot(
            tsdb, slo_cfg=cfg, alerts_path=alerts_path,
            notifications_path=notifications_path,
        )
        if args.json_out:
            print(console_mod.snapshot_json(snap))
        else:
            print(console_mod.render(
                snap, color=color, alerts_only=args.alerts_only
            ))
        return 0
    console_mod.watch(
        tsdb, slo_cfg=cfg, alerts_path=alerts_path,
        refresh_s=args.refresh, color=color,
        max_frames=args.frames if args.frames > 0 else None,
        notifications_path=notifications_path,
        alerts_only=args.alerts_only,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
