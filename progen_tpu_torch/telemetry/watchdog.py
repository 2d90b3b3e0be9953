"""Stall watchdog: stack dumps + last-spans report when steps stop.

The port's copy of the JAX package's ``telemetry/watchdog.py``. When a
run stops making progress, the post-mortem question is always the same:
*where was the process when it stopped?* The watchdog answers it while
the process is still alive to be asked.

A daemon thread watches a heartbeat the owning loop pings via
``beat()`` (once per completed step). When no beat lands within
``deadline_s`` it fires ONCE:

  * all-thread Python stacks via ``faulthandler.dump_traceback`` — this
    does not need the stalled threads' cooperation, so it works even
    when the main thread is stuck inside a device call;
  * a last-spans report from the process Telemetry: the spans currently
    OPEN (where the process is now) and the most recent completed ones
    (how it got there);
  * an optional ``on_stall`` callback.

It re-arms if beats resume (a transient stall logs one report and the
run continues). The thread never kills the process — the surrounding
timeout machinery owns that decision; the watchdog's job is to make
sure the kill leaves evidence.

Escalation (``escalate_after=N``): instead of reporting once per
stall, the watchdog re-reports every further ``deadline_s`` the stall
persists, and on the Nth consecutive report for the SAME stall it
snapshots ``torch.cuda.memory_stats`` for every visible card plus the
open-span list into the telemetry sink (events.jsonl) and the report
stream — the full forensic record, captured BEFORE the surrounding
timeout kills the run.
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import time
from typing import Callable, Optional

from progen_tpu_torch.telemetry.registry import get_registry
from progen_tpu_torch.telemetry.spans import (
    Telemetry,
    get_telemetry,
    host_index,
)


class StallWatchdog:
    def __init__(
        self,
        deadline_s: float,
        *,
        file=None,
        telemetry: Optional[Telemetry] = None,
        on_stall: Optional[Callable[[dict], None]] = None,
        poll_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        escalate_after: int = 0,
        memory_stats_fn: Optional[Callable[[], list]] = None,
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self._file = file  # None -> stderr at fire time
        self._telemetry = telemetry
        self._on_stall = on_stall
        self._poll_s = poll_s if poll_s is not None else min(
            self.deadline_s / 4.0, 1.0
        )
        self._clock = clock
        self._last_beat = clock()
        self._fired_for_beat: Optional[float] = None
        self._fires_this_stall = 0
        self.fire_count = 0
        self.escalate_after = int(escalate_after)
        self.escalation_count = 0
        self._memory_stats_fn = memory_stats_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----- lifecycle ------------------------------------------------------

    def start(self) -> "StallWatchdog":
        self._last_beat = self._clock()
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----- heartbeat ------------------------------------------------------

    def beat(self) -> None:
        """Progress ping; call once per completed unit of work."""
        self._last_beat = self._clock()

    @property
    def fired(self) -> bool:
        return self.fire_count > 0

    # ----- the watcher ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            last = self._last_beat
            stalled_s = self._clock() - last
            if stalled_s < self.deadline_s:
                continue
            if self._fired_for_beat != last:
                # a NEW stall (beats resumed since the last report)
                self._fired_for_beat = last
                self._fires_this_stall = 0
            if self.escalate_after > 0:
                # periodic re-report: the (n+1)-th fires once the stall
                # has lasted (n+1) deadlines
                if stalled_s < self.deadline_s * (self._fires_this_stall + 1):
                    continue
            elif self._fires_this_stall:
                continue  # legacy: once per stall; re-arm on beat
            self._fires_this_stall += 1
            self.fire_count += 1
            try:
                self._fire(stalled_s)
            except Exception:
                pass  # a broken reporter must not crash the daemon
            if (
                self.escalate_after > 0
                and self._fires_this_stall == self.escalate_after
            ):
                self.escalation_count += 1
                try:
                    self._escalate(stalled_s)
                except Exception:
                    pass

    def _fire(self, stalled_s: float) -> None:
        get_registry().inc("stalls")
        out = self._file if self._file is not None else sys.stderr
        tel = (
            self._telemetry
            if self._telemetry is not None
            else get_telemetry()
        )
        report = {
            "ev": "stall",
            "ts": time.time(),
            # explicit host stamp (not just the sink's pid tag): a
            # fleet-merged trace must pin the stall to the right track
            # even when the report is read outside the emitting process
            "host": host_index(),
            "stalled_s": round(stalled_s, 3),
            "deadline_s": self.deadline_s,
            "open_spans": [
                {"span": r["span"], "ts": r["ts"]}
                for r in tel.open_spans()
            ],
            "recent_spans": [
                {"span": r["span"], "dur_s": r.get("dur_s")}
                for r in tel.recent_spans(8)
            ],
        }
        print(
            f"[stall-watchdog] host {report['host']}: no step completed "
            f"in {stalled_s:.1f}s "
            f"(deadline {self.deadline_s:.0f}s); open spans: "
            f"{[r['span'] for r in report['open_spans']] or ['<none>']}; "
            "all-thread stacks follow",
            file=out,
            flush=True,
        )
        try:
            # fd-level dump: works even when stalled threads hold locks
            faulthandler.dump_traceback(file=out, all_threads=True)
        except (AttributeError, ValueError, OSError):
            # sink has no usable fileno (StringIO, wrapped streams):
            # same information via the interpreter's frame snapshot
            import traceback

            for tid, frame in sys._current_frames().items():
                print(f"Thread {tid}:", file=out)
                traceback.print_stack(frame, file=out)
        try:
            out.flush()
        except (OSError, ValueError):
            pass
        tel.emit(report)
        if self._on_stall is not None:
            self._on_stall(report)

    def _escalate(self, stalled_s: float) -> None:
        """Nth consecutive report for one stall: snapshot per-device
        allocator state + the open spans into the telemetry sink, so the
        record survives the kill that usually follows."""
        get_registry().inc("stall_escalations")
        out = self._file if self._file is not None else sys.stderr
        tel = (
            self._telemetry
            if self._telemetry is not None
            else get_telemetry()
        )
        mem = (
            self._memory_stats_fn
            if self._memory_stats_fn is not None
            else _device_memory_stats
        )()
        record = {
            "ev": "stall_escalation",
            "ts": time.time(),
            "host": host_index(),
            "stalled_s": round(stalled_s, 3),
            "consecutive_reports": self._fires_this_stall,
            "memory_stats": mem,
            "open_spans": [
                {"span": r["span"], "ts": r["ts"]}
                for r in tel.open_spans()
            ],
        }
        print(
            f"[stall-watchdog] host {record['host']}: ESCALATION after "
            f"{self._fires_this_stall} consecutive stall reports "
            f"({stalled_s:.1f}s): device memory + open spans snapshotted "
            "to the event stream",
            file=out,
            flush=True,
        )
        tel.emit(record)


def _device_memory_stats() -> list:
    """One ``torch.cuda.memory_stats(i)`` per visible card, its int and
    float fields only; [] without a card — the escalation record is still
    useful for its open-span list."""
    import torch

    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i) or {}
        except Exception:
            stats = {}
        out.append({"device": str(i), **{
            k: v for k, v in stats.items() if isinstance(v, (int, float))
        }})
    return out
