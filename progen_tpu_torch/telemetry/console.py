"""Ops console rendering: TSDB → snapshot dict → ANSI dashboard.

``build_snapshot`` is the single source of truth for what the console
knows — ``progen-tpu-torch-top`` renders it as a live ANSI screen for humans
and dumps it verbatim as JSON for scripts (``--once --json``), so CI
asserts against exactly what an operator would see:

  * one row per source: up bit, exposition age, slot occupancy, queue
    depth, ttft/itl p95, completed requests, decode tokens;
  * fleet rollup from ``fleet_series`` (reset-safe summed counters,
    merged quantiles, liveness gauges) — the totals line equals the
    sum of the per-source Prometheus files at scrape time;
  * SLO states when an objectives TOML is given (same ``evaluate``
    path as ``slo-report --tsdb``);
  * the alert tail and the TSDB's own health (blocks, bytes, torn
    lines dropped) — a console that silently lost history is itself
    an outage;
  * when an alert-router ledger exists, a notifications tail plus the
    delivery state-machine counts (``sent``/``failed``/``silenced``/
    ``deduped`` and the ``routed`` total) so CI can assert WHO was
    told, not just what fired; ``--alerts-only`` renders just the
    alerting panes for an on-call terminal.

Rendering is pure string-building (no curses): the watch loop clears
the screen between frames, which keeps the console dumb enough to pipe.

The port's copy of the JAX package's ``telemetry/console.py``.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

from progen_tpu_torch.telemetry.collector import (
    fleet_exemplars,
    fleet_series,
    latest_by_source,
)
from progen_tpu_torch.telemetry.slo import evaluate, results_payload
from progen_tpu_torch.telemetry.trace import LineDrops, iter_jsonl

_RESET = "\x1b[0m"
_BOLD = "\x1b[1m"
_GREEN = "\x1b[32m"
_RED = "\x1b[31m"
_YELLOW = "\x1b[33m"
_DIM = "\x1b[2m"

CLEAR_SCREEN = "\x1b[2J\x1b[H"


def build_snapshot(
    tsdb,
    slo_cfg=None,
    alerts_path=None,
    max_alerts: int = 8,
    notifications_path=None,
    max_notifications: int = 8,
) -> dict:
    """Everything the console shows, as one JSON-able dict."""
    drops = LineDrops()
    samples = [r for r in tsdb.read(drops) if r.get("ev") == "sample"]
    per_source = latest_by_source(samples)
    fleet = fleet_series(samples)
    fleet_now: Dict[str, float] = fleet[-1][1] if fleet else {}
    as_of = fleet[-1][0] if fleet else None
    sources = [
        {
            "name": rec["source"],
            "role": rec.get("role", ""),
            "up": bool(rec.get("up")),
            "age_s": rec.get("age_s", 0.0),
            "counters": rec.get("counters", {}),
            "gauges": rec.get("gauges", {}),
            "timings": rec.get("timings", {}),
        }
        for rec in sorted(
            per_source.values(), key=lambda r: (r.get("role", ""), r["source"])
        )
    ]
    slo: List[dict] = []
    gate = None
    if slo_cfg is not None and fleet:
        payload = results_payload(evaluate(slo_cfg, [fleet]))
        gate = payload["exit"]
        slo = payload["results"]
    alerts: List[dict] = []
    if alerts_path is not None:
        try:
            alerts = [
                rec for rec in iter_jsonl(alerts_path, drops)
                if rec.get("ev") == "alert"
            ][-max_alerts:]
        except OSError:
            pass
    notifications: List[dict] = []
    notify_counts = {
        "sent": 0, "failed": 0, "silenced": 0, "deduped": 0, "routed": 0
    }
    if notifications_path is not None:
        try:
            all_notes = [
                rec for rec in iter_jsonl(notifications_path, drops)
                if rec.get("ev") == "notify"
            ]
        except OSError:
            all_notes = []
        for rec in all_notes:
            status = rec.get("status", "")
            if status in notify_counts:
                notify_counts[status] += 1
        notify_counts["routed"] = (
            notify_counts["sent"] + notify_counts["failed"]
        )
        notifications = all_notes[-max_notifications:]
    return {
        "as_of": as_of,
        "sources": sources,
        "fleet": fleet_now,
        # worst-K trace exemplars per timing family, fleet-wide: the
        # request ids behind the merged p99 (per-source exemplars ride
        # each source's timings dict above)
        "exemplars": fleet_exemplars(samples),
        "slo": slo,
        "slo_exit": gate,
        "alerts": alerts,
        "notifications": notifications,
        "notify_counts": notify_counts,
        "tsdb": {
            "blocks": len(tsdb.blocks()),
            "bytes": tsdb.total_bytes(),
            "dropped_lines": tsdb.dropped_lines + drops.count,
        },
    }


def _c(s: str, code: str, color: bool) -> str:
    return f"{code}{s}{_RESET}" if color else s


def _num(v, fmt: str = "{:.0f}") -> str:
    if v is None:
        return "-"
    try:
        return fmt.format(float(v))
    except (TypeError, ValueError):
        return "-"


def _tq(rec: dict, fam: str, key: str):
    return rec.get("timings", {}).get(fam, {}).get(key)


def _delivery_tags(snap: dict) -> Dict[tuple, List[str]]:
    """(kind, who, state) → delivery statuses seen in the notification
    tail, so the alerts pane can show routed/silenced state inline."""
    tags: Dict[tuple, List[str]] = {}
    for n in snap.get("notifications", []):
        key = (
            n.get("kind", ""),
            n.get("objective") or n.get("source") or "",
            n.get("state", ""),
        )
        status = n.get("status", "")
        if status and status not in tags.setdefault(key, []):
            tags[key].append(status)
    return tags


def render(snap: dict, color: bool = True,
           alerts_only: bool = False) -> str:
    """Snapshot → dashboard text (no trailing clear; the watch loop
    owns the screen). ``alerts_only`` keeps the header, SLO, alert and
    notification panes and drops the per-source/fleet tables."""
    lines: List[str] = []
    as_of = snap.get("as_of")
    stamp = (
        time.strftime("%H:%M:%S", time.localtime(as_of))
        if as_of else "--:--:--"
    )
    fleet = snap.get("fleet", {})
    n_up = int(fleet.get("fleet_up", 0))
    n_all = int(fleet.get("fleet_sources", 0))
    head = f"progen-tpu-torch-top  as of {stamp}  sources {n_up}/{n_all} up"
    lines.append(_c(head, _BOLD, color))
    if alerts_only:
        lines.extend(_render_alert_panes(snap, color))
        return "\n".join(lines)
    hdr = (
        f"{'SOURCE':<10} {'ROLE':<8} {'UP':<5} {'AGE':>6} {'SLOTS':>6} "
        f"{'QUEUE':>6} {'TTFT95':>8} {'ITL95':>8} {'DONE':>8} {'TOKENS':>9}"
    )
    lines.append(_c(hdr, _DIM, color))
    for src in snap.get("sources", []):
        up = src.get("up")
        g = src.get("gauges", {})
        c = src.get("counters", {})
        row = (
            f"{src.get('name', '?'):<10} {src.get('role', ''):<8} "
            f"{_c('up', _GREEN, color) if up else _c('DOWN', _RED, color):<5}"
            f"{'' if color else ''} "
            f"{_num(src.get('age_s'), '{:.1f}s'):>6} "
            f"{_num(g.get('slot_occupancy', g.get('active_slots'))):>6} "
            f"{_num(g.get('queue_depth')):>6} "
            f"{_num(_tq(src, 'ttft_s', 'p95_s'), '{:.3f}'):>8} "
            f"{_num(_tq(src, 'itl_s', 'p95_s'), '{:.3f}'):>8} "
            f"{_num(c.get('requests_completed')):>8} "
            f"{_num(c.get('decode_tokens', c.get('tokens_forwarded'))):>9}"
        )
        lines.append(row)
    lines.append(
        "fleet: "
        f"replicas {int(fleet.get('replicas_live', 0))}/"
        f"{int(fleet.get('replicas_total', 0))} live  "
        f"done {_num(fleet.get('requests_completed'))}  "
        f"tokens {_num(fleet.get('decode_tokens'))}  "
        f"ttft p95 {_num(fleet.get('ttft_s_p95_s'), '{:.3f}')}s  "
        f"queue max {_num(fleet.get('queue_depth'))}"
    )
    exemplars = snap.get("exemplars", {})
    if exemplars:
        lines.append(_c("slowest traces", _BOLD, color))
        for fam in sorted(exemplars):
            worst = exemplars[fam][:3]
            tail = "  ".join(
                f"{e.get('trace_id', '?')} ({_num(e.get('value'), '{:.3f}')}s)"
                for e in worst
            )
            lines.append(f"  {fam:<12} {tail}")
    lines.extend(_render_alert_panes(snap, color))
    t = snap.get("tsdb", {})
    lines.append(_c(
        f"tsdb: {t.get('blocks', 0)} blocks, {t.get('bytes', 0)} bytes, "
        f"{t.get('dropped_lines', 0)} torn lines dropped",
        _DIM, color,
    ))
    return "\n".join(lines)


def _render_alert_panes(snap: dict, color: bool) -> List[str]:
    """SLO states, the alert tail (annotated with delivery status when
    a router ledger is present), and the notifications tail."""
    lines: List[str] = []
    slo = snap.get("slo", [])
    if slo:
        lines.append(_c("SLO", _BOLD, color))
        for r in slo:
            state = r.get("state", "?")
            code = {
                "ok": _GREEN, "warn": _YELLOW, "burning": _RED
            }.get(state, _DIM)
            burn = r.get("burn_long")
            lines.append(
                f"  {r.get('objective', '?'):<22} "
                f"{_c(state, code, color):<8} "
                f"burn {_num(burn, '{:.2f}')}"
                + (f"  ({r['detail']})" if r.get("detail") else "")
            )
    tags = _delivery_tags(snap)
    alerts = snap.get("alerts", [])
    if alerts:
        lines.append(_c("recent alerts", _BOLD, color))
        for a in alerts[-5:]:
            ts = time.strftime(
                "%H:%M:%S", time.localtime(a.get("ts", 0))
            )
            who = a.get("objective") or a.get("source") or "?"
            state = a.get("state", "?")
            code = _GREEN if state in ("fresh", "resolved") else _RED
            delivered = tags.get((a.get("kind", ""), who, state), [])
            suffix = (
                "  [" + ",".join(delivered) + "]" if delivered else ""
            )
            lines.append(
                f"  {ts} {a.get('kind', '?'):<10} {who:<18} "
                f"{_c(state, code, color)}"
                + _c(suffix, _DIM, color)
            )
    notes = snap.get("notifications", [])
    if notes:
        counts = snap.get("notify_counts", {})
        lines.append(_c(
            "notifications  "
            f"routed {counts.get('routed', 0)}  "
            f"silenced {counts.get('silenced', 0)}  "
            f"deduped {counts.get('deduped', 0)}  "
            f"failed {counts.get('failed', 0)}",
            _BOLD, color,
        ))
        for n in notes[-5:]:
            ts = time.strftime(
                "%H:%M:%S", time.localtime(n.get("ts", 0))
            )
            status = n.get("status", "?")
            code = {
                "sent": _GREEN, "failed": _RED, "silenced": _YELLOW
            }.get(status, _DIM)
            route = n.get("route") or "-"
            lines.append(
                f"  {ts} {route:<10} "
                f"{n.get('fingerprint', '?'):<28} "
                f"{n.get('state', '?'):<9} {_c(status, code, color)}"
                + (f" ({n['reason']})" if n.get("reason") else "")
            )
    return lines


def snapshot_json(snap: dict) -> str:
    return json.dumps(snap, indent=2, sort_keys=True, default=str)


def watch(
    tsdb,
    slo_cfg=None,
    alerts_path=None,
    refresh_s: float = 2.0,
    color: bool = True,
    max_frames: Optional[int] = None,
    out=None,
    notifications_path=None,
    alerts_only: bool = False,
):
    """Live loop: clear screen, render, wait. ``q`` quits when stdin is
    a TTY; otherwise runs until ``max_frames`` (None = forever) — the
    headless path CI and tests use."""
    import sys

    out = sys.stdout if out is None else out
    frames = 0
    while max_frames is None or frames < max_frames:
        snap = build_snapshot(
            tsdb, slo_cfg=slo_cfg, alerts_path=alerts_path,
            notifications_path=notifications_path,
        )
        out.write(
            CLEAR_SCREEN
            + render(snap, color=color, alerts_only=alerts_only)
            + "\n"
        )
        out.flush()
        frames += 1
        if max_frames is not None and frames >= max_frames:
            break
        if _wait_or_quit(refresh_s):
            break


def _wait_or_quit(timeout_s: float) -> bool:
    """Sleep ``timeout_s``; True means the operator pressed ``q``."""
    import select
    import sys

    stdin = sys.stdin
    if not hasattr(stdin, "fileno"):
        time.sleep(timeout_s)
        return False
    try:
        is_tty = stdin.isatty()
    except (ValueError, OSError):
        is_tty = False
    if not is_tty:
        time.sleep(timeout_s)
        return False
    import termios
    import tty

    fd = stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        r, _, _ = select.select([stdin], [], [], timeout_s)
        if r:
            ch = stdin.read(1)
            return ch in ("q", "Q")
        return False
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
