"""Flight recorder + on-demand profiling: the black box in every
long-lived process. The port's copy of the JAX package's
``telemetry/flight.py``; its two device seams are the card's allocator
statistics (``torch.cuda.memory_stats``) and the profiler window
(:class:`TorchProfiler`, over ``torch.profiler.profile``).

When a page fires or a replica dies, the evidence trail is usually
whatever happened to be flushed. This module keeps the evidence
*resident* and gets it to disk at the moment it matters:

**Flight recorder.** A bounded, lock-light in-memory ring of every
record that flows through ``Telemetry.emit`` — spans, per-request
``ev:"req"`` events, retry/chaos/anomaly/stall instants — captured via
the ``EMIT_TAPS`` seam in spans.py, so the ring fills even on a
sink-less process. ``dump()`` writes an atomic, digest-stamped
``flight-<host>-<ts>.json`` (tmp + fsync + rename: a SIGKILL at any
instant leaves either no file or a complete verifiable one, never a
torn one). The payload carries the ring, the currently OPEN spans,
all-thread Python stacks, ``torch.cuda.memory_stats()``, and an optional
metrics snapshot — everything a post-mortem asks for, and the records
render in Perfetto next to surviving hosts (``export-trace`` /
``stitch`` accept dumps directly).

Dumps fire automatically on the crash-adjacent edges the ring itself
observes (the tap doubles as the trigger):

  * an imminent chaos ``kill`` injection (the injector emits its
    ``ev:"chaos"`` record BEFORE the SIGKILL — the recorder dumps in
    that window, which is how a SIGKILLed serve replica still leaves
    its black box);
  * a watchdog ``stall_escalation`` (the stacks that used to reach
    only stderr now land on disk);
  * an ``anomaly_rollback``;
  * an SLO ``burning`` edge.

plus explicit calls from fatal-signal handlers and an installed
``sys.excepthook``. Arming costs one deque append per emitted record —
the pool's step time with and without it is measured by
``chip_smoke.py``'s ``observability-base`` phase.

**On-demand profiling.** :class:`ProfilePinWatcher` mirrors the
``reload.pin`` control seam (serving/reload.py): an operator — or the
collector, automatically on the first ``burning`` edge via
:func:`request_profile` — writes a ``profile.pin`` file; the live
serve/train loop polls it between steps, starts a bounded
``torch.profiler`` trace window, answers through an atomic
``profile.pin.ack``, and stops the window at its deadline. No restart,
no wedge: a pin that cannot start (profiler unavailable, window
already active, rate limit) is REJECTED with a reason and not retried
until its content changes.

The ``ev:"flight"`` (op armed/dumped/truncated) and ``ev:"profile"``
(op requested/started/stopped/rejected) record grammars live HERE.
``flight/dump`` and ``profile/window`` are chaos
sites: the dump path and the profiler window are both rehearsable
failure points.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

from progen_tpu_torch.telemetry.registry import get_registry
from progen_tpu_torch.telemetry.spans import (
    EMIT_TAPS,
    get_telemetry,
    host_index,
    span,
)
from progen_tpu_torch.telemetry.watchdog import _device_memory_stats

# ring size: at serve's per-token event rate this is the last few
# hundred requests' worth of context — enough to reconstruct what the
# process was doing, small enough that a dump is a few hundred KB
DEFAULT_RING = 1024

DUMP_PREFIX = "flight-"


# ---------------------------------------------------------------------------
# dump format: {"payload": {...}, "digest": sha256(canonical payload)}
# ---------------------------------------------------------------------------


def _canonical(payload: dict) -> bytes:
    return json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=str
    ).encode("utf-8")


def seal(payload: dict) -> dict:
    """Wrap a payload with its content digest — the reader's proof the
    dump is complete (a torn write cannot produce a matching digest)."""
    return {
        "payload": payload,
        "digest": hashlib.sha256(_canonical(payload)).hexdigest(),
    }


def verify_dump(path) -> dict:
    """Load + digest-verify a flight dump; returns the payload.
    Raises ``ValueError`` on unreadable/torn/forged files."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable flight dump {path}: {e}")
    payload = doc.get("payload") if isinstance(doc, dict) else None
    digest = doc.get("digest") if isinstance(doc, dict) else None
    if not isinstance(payload, dict) or not digest:
        raise ValueError(f"not a flight dump: {path}")
    want = hashlib.sha256(_canonical(payload)).hexdigest()
    if want != digest:
        raise ValueError(
            f"flight dump digest mismatch: {path} "
            f"(file {digest[:12]}.. != computed {want[:12]}..)"
        )
    return payload


def dump_records(path) -> list:
    """The events.jsonl-equivalent record stream inside a verified
    dump — what export-trace/stitch/query consume."""
    return list(verify_dump(path).get("records") or [])


def is_dump_path(path) -> bool:
    p = Path(path)
    return p.name.startswith(DUMP_PREFIX) and p.suffix == ".json"


def find_dumps(directory) -> list:
    """All flight dumps under ``directory`` (recursive), oldest first."""
    root = Path(directory)
    try:
        paths = sorted(root.rglob(DUMP_PREFIX + "*.json"))
    except OSError:
        return []
    return [p for p in paths if p.is_file()]


def _thread_stacks() -> dict:
    """All-thread Python stacks as strings — the watchdog's stderr
    payload, but on disk."""
    import traceback

    out = {}
    try:
        frames = sys._current_frames()
    except Exception:
        return out
    for tid, frame in frames.items():
        try:
            out[str(tid)] = "".join(traceback.format_stack(frame))[-8000:]
        except Exception:
            continue
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry records + atomic
    crash-path dumps. Lock-light by construction: the hot path is one
    GIL-atomic ``deque.append``; only ``dump()`` takes a lock."""

    def __init__(
        self,
        out_dir,
        *,
        ring: int = DEFAULT_RING,
        metrics_fn: Optional[Callable[[], dict]] = None,
        host: Optional[int] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.ring = max(1, int(ring))
        self.out_dir = Path(out_dir)
        self._ring: deque = deque(maxlen=self.ring)
        self._metrics_fn = metrics_fn
        self._host = host
        self._clock = clock
        self._seen = 0
        self.dump_count = 0
        self._dump_lock = threading.Lock()
        self._armed = False
        self._old_excepthook = None

    @property
    def host(self) -> int:
        return self._host if self._host is not None else host_index()

    # ----- arming ---------------------------------------------------------

    def arm(self) -> "FlightRecorder":
        """Register the emit tap + excepthook and announce. Idempotent."""
        if self._armed:
            return self
        EMIT_TAPS.append(self.tap)
        self._old_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._armed = True
        get_telemetry().emit({
            "ev": "flight", "ts": self._clock(), "op": "armed",
            "ring": self.ring, "host": self.host,
        })
        return self

    def disarm(self) -> None:
        if not self._armed:
            return
        try:
            EMIT_TAPS.remove(self.tap)
        except ValueError:
            pass
        if sys.excepthook is self._excepthook \
                and self._old_excepthook is not None:
            sys.excepthook = self._old_excepthook
        self._armed = False

    @property
    def armed(self) -> bool:
        return self._armed

    # ----- hot path -------------------------------------------------------

    def tap(self, record: dict) -> None:
        """The EMIT_TAPS hook: one append, then edge detection for the
        auto-dump triggers. Must never raise (it runs inside every
        ``Telemetry.emit`` on the serving/training hot path)."""
        try:
            self._seen += 1
            self._ring.append(record)
            ev = record.get("ev")
            if ev == "chaos":
                if record.get("kind") == "kill":
                    # the injector SIGKILLs right after this emit
                    # returns: this is the black box's last chance
                    self.dump("chaos_kill",
                              note=str(record.get("site", "")))
            elif ev == "stall_escalation":
                self.dump("stall_escalation")
            elif ev == "anomaly_rollback":
                self.dump("anomaly_rollback")
            elif ev == "slo" and record.get("state") == "burning":
                self.dump("slo_burning",
                          note=str(record.get("objective", "")))
        except Exception:
            pass

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            self.dump("unhandled_exception", note=repr(exc)[:300])
        except Exception:
            pass
        hook = self._old_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)

    # ----- dumping --------------------------------------------------------

    def payload(self, reason: str, note: str = "") -> dict:
        tel = get_telemetry()
        records = list(self._ring)
        payload = {
            "flight": 1,  # format version for readers
            "reason": str(reason),
            "host": self.host,
            "ts": self._clock(),
            "ring": self.ring,
            "truncated": max(0, self._seen - len(records)),
            "records": records,
            "open_spans": tel.open_spans(),
            "stacks": _thread_stacks(),
            "memory_stats": _device_memory_stats(),
        }
        if note:
            payload["note"] = note
        if self._metrics_fn is not None:
            try:
                payload["metrics"] = self._metrics_fn()
            except Exception:
                payload["metrics"] = None
        return payload

    def dump(self, reason: str, note: str = "") -> Optional[Path]:
        """Atomic forensic dump; returns the path or None. Never raises
        — a broken dump path must not take down the process it is
        trying to describe. Non-blocking on the lock: a dump triggered
        from INSIDE a dump (the chaos injector's own ev:"chaos" emit at
        the flight/dump span re-enters the tap on the same thread) must
        skip, not deadlock — one black box is enough."""
        if not self._dump_lock.acquire(blocking=False):
            return None
        try:
            return self._dump(reason, note)
        except Exception:
            return None
        finally:
            self._dump_lock.release()

    def _dump(self, reason: str, note: str) -> Path:
        payload = self.payload(reason, note)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        stamp = int(payload["ts"] * 1000)
        final = self.out_dir / f"{DUMP_PREFIX}{self.host}-{stamp}.json"
        n = 0
        while final.exists():  # same-ms collision: bump, never clobber
            n += 1
            final = self.out_dir / (
                f"{DUMP_PREFIX}{self.host}-{stamp}-{n}.json"
            )
        tmp = final.with_name(final.name + ".tmp")
        # the span makes the dump path a chaos site (flight/dump): a
        # kill at entry leaves no file; the fsync+rename below means a
        # kill mid-write leaves only the .tmp — a reader never sees a
        # torn flight-*.json
        with span("flight/dump", reason=str(reason)):
            data = json.dumps(seal(payload)).encode("utf-8")
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        self.dump_count += 1
        get_registry().inc("flight_dumps")
        get_telemetry().emit({
            "ev": "flight", "ts": self._clock(), "op": "dumped",
            "reason": str(reason), "path": str(final),
            "records": len(payload["records"]),
        })
        if payload["truncated"]:
            get_telemetry().emit({
                "ev": "flight", "ts": self._clock(), "op": "truncated",
                "dropped": payload["truncated"],
            })
        return final


# process-global recorder: CLIs arm once at startup; deep code
# (signal handlers, watchdogs) reaches it without threading a handle
_RECORDER: Optional[FlightRecorder] = None


def arm(out_dir, *, ring: int = DEFAULT_RING,
        metrics_fn: Optional[Callable[[], dict]] = None) -> FlightRecorder:
    """Arm the process-global flight recorder (replacing any prior)."""
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.disarm()
    _RECORDER = FlightRecorder(
        out_dir, ring=ring, metrics_fn=metrics_fn
    ).arm()
    return _RECORDER


def disarm() -> None:
    global _RECORDER
    if _RECORDER is not None:
        _RECORDER.disarm()
        _RECORDER = None


def get_recorder() -> Optional[FlightRecorder]:
    return _RECORDER


def dump_now(reason: str, note: str = "") -> Optional[Path]:
    """Dump the process-global recorder, if armed (fatal-signal
    handlers call this — it never raises)."""
    rec = _RECORDER
    if rec is None:
        return None
    return rec.dump(reason, note)


# ---------------------------------------------------------------------------
# on-demand profiling: the profile.pin seam
# ---------------------------------------------------------------------------


class TorchProfiler:
    """``start_trace(dir)`` / ``stop_trace()`` over
    ``torch.profiler.profile``, the interface a :class:`ProfilePinWatcher`
    drives. It records CPU and CUDA activities when ``cuda`` is true
    (default: a card is present), CPU alone otherwise; ``stop_trace``
    writes one Chrome trace, ``profile_<pid>.pt.trace.json``, into the
    window's directory. One window at a time."""

    def __init__(self, cuda: Optional[bool] = None):
        self.cuda = cuda
        self._prof = None
        self._dir: Optional[Path] = None
        self.last_path: Optional[Path] = None
        self.last_export_s = 0.0

    def start_trace(self, trace_dir: str) -> None:
        import torch

        if self._prof is not None:
            raise RuntimeError("a profiler window is already open")
        cuda = torch.cuda.is_available() if self.cuda is None else self.cuda
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self._prof, self._dir = prof, Path(trace_dir)

    def stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            raise RuntimeError("no profiler window is open")
        prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        path = self._dir / f"profile_{os.getpid()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        self.last_export_s = time.perf_counter() - t0
        self.last_path = path


def request_profile(pin_path, duration_s: Optional[float] = None,
                    token: Optional[str] = None) -> str:
    """Write a ``profile.pin`` atomically (the operator/collector side
    of the seam) and ledger the request. Returns the pin token the ack
    will echo."""
    pin_path = Path(pin_path)
    if token is None:
        token = f"prof-{int(time.time() * 1000)}-{os.getpid()}"
    content = token if duration_s is None else f"{token} {duration_s:g}"
    pin_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = pin_path.with_name(pin_path.name + ".tmp")
    with tmp.open("w") as f:
        f.write(content)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, pin_path)
    get_telemetry().emit({
        "ev": "profile", "ts": time.time(), "op": "requested",
        "pin": token, "path": str(pin_path),
    })
    return token


class ProfilePinWatcher:
    """Poll a ``profile.pin`` control file and run bounded
    ``torch.profiler`` trace windows on a live process — the
    ``reload.pin`` seam (serving/reload.py), aimed at the profiler.

    Pin content: ``<token>[ <seconds>]`` — the token names the request
    (acks echo it; :func:`request_profile` mints unique ones), the
    optional seconds bound the window (clamped to ``max_window_s``).
    A handled or rejected pin is not re-run until its content changes.
    """

    def __init__(
        self,
        pin_path,
        out_dir,
        *,
        max_window_s: float = 10.0,
        min_interval_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        profiler=None,
    ):
        self.pin_path = Path(pin_path)
        self.out_dir = Path(out_dir)
        self.max_window_s = float(max_window_s)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        # test seam: any object with start_trace(dir)/stop_trace();
        # None -> TorchProfiler(), resolved lazily at window start
        self._profiler = profiler
        self._watch_mark = 0.0
        self._acked: Optional[tuple] = None  # (pin, status) last written
        self._failed_pin: Optional[str] = None
        self._done_pin: Optional[str] = None
        self._last_start = float("-inf")
        # active window: (token, deadline, trace_dir, span_cm, t0)
        self._active: Optional[tuple] = None
        self.window_count = 0

    # ----- pin file (the reload.py idioms) --------------------------------

    def read_pin(self) -> Optional[str]:
        try:
            content = self.pin_path.read_text().strip()
        except OSError:
            return None
        return content or None

    def _write_ack(self, pin: str, status: str, reason: str = "") -> None:
        if self._acked == (pin, status):
            return
        rec = {"pin": pin, "status": status, "ts": time.time()}
        if reason:
            rec["reason"] = reason
        ack = self.pin_path.with_name(self.pin_path.name + ".ack")
        tmp = ack.with_name(ack.name + ".tmp")
        try:
            with tmp.open("w") as f:
                f.write(json.dumps(rec))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, ack)
        except OSError:
            return
        self._acked = (pin, status)

    def _reject(self, content: str, token: str, reason: str) -> None:
        self._failed_pin = content
        get_registry().inc("profile_rejected")
        get_telemetry().emit({
            "ev": "profile", "ts": time.time(), "op": "rejected",
            "pin": token, "reason": reason,
        })
        self._write_ack(token, "rejected", reason)

    # ----- the window -----------------------------------------------------

    @property
    def active(self) -> bool:
        return self._active is not None

    def _parse_pin(self, content: str) -> tuple:
        """(token, window_s) from pin content; bad durations clamp."""
        parts = content.split()
        token = parts[0]
        window_s = self.max_window_s
        if len(parts) > 1:
            try:
                window_s = float(parts[1])
            except ValueError:
                pass
        window_s = min(max(window_s, 0.1), self.max_window_s)
        return token, window_s

    def _start(self, content: str, token: str, window_s: float) -> bool:
        trace_dir = self.out_dir / f"profile-{token}"
        span_cm = span("profile/window", pin=token)
        try:
            span_cm.__enter__()  # chaos site: a fault here is rejected
        except Exception as e:
            self._reject(content, token, f"{type(e).__name__}: {e}")
            return False
        try:
            profiler = self._profiler
            if profiler is None:
                profiler = TorchProfiler()
            trace_dir.mkdir(parents=True, exist_ok=True)
            profiler.start_trace(str(trace_dir))
        except Exception as e:
            span_cm.__exit__(None, None, None)
            self._reject(content, token,
                         f"profiler_unavailable: {type(e).__name__}: {e}")
            return False
        self._profiler = profiler
        now = self._clock()
        self._last_start = now
        self._active = (token, now + window_s, trace_dir, span_cm,
                        time.perf_counter())
        self.window_count += 1
        get_registry().inc("profile_windows")
        get_telemetry().emit({
            "ev": "profile", "ts": time.time(), "op": "started",
            "pin": token, "window_s": round(window_s, 3),
            "trace_dir": str(trace_dir),
        })
        self._write_ack(token, "started")
        return True

    def _stop(self) -> None:
        token, _, trace_dir, span_cm, t0 = self._active
        self._active = None
        try:
            self._profiler.stop_trace()
        except Exception:
            pass  # a broken stop must not wedge the loop
        span_cm.__exit__(None, None, None)
        rec = {
            "ev": "profile", "ts": time.time(), "op": "stopped",
            "pin": token,
            "duration_s": round(time.perf_counter() - t0, 3),
            "trace_dir": str(trace_dir),
        }
        export_s = getattr(self._profiler, "last_export_s", None)
        if export_s is not None:
            rec["export_s"] = round(export_s, 6)
        get_telemetry().emit(rec)
        self._write_ack(token, "stopped")

    def close(self) -> None:
        """Shutdown seam: stop an in-flight window so the trace flushes."""
        if self._active is not None:
            self._stop()

    # ----- loop-thread poll -----------------------------------------------

    def poll_watch(self, interval_s: float = 2.0) -> bool:
        """Called by the owning loop between steps. Finishes a due
        window, then (throttled) checks the pin for new work. Returns
        True when a window was started."""
        now = self._clock()
        if self._active is not None:
            _, deadline, _, _, _ = self._active
            if now >= deadline:
                self._stop()
            return False
        if now - self._watch_mark < interval_s:
            return False
        self._watch_mark = now
        content = self.read_pin()
        if content is None or content == self._failed_pin \
                or content == self._done_pin:
            return False
        token, window_s = self._parse_pin(content)
        if now - self._last_start < self.min_interval_s:
            self._reject(content, token, "rate_limited")
            return False
        if not self._start(content, token, window_s):
            return False
        self._done_pin = content
        return True


# ---------------------------------------------------------------------------
# trace query: one timeline per trace_id across every evidence stream
# ---------------------------------------------------------------------------


def _describe(rec: dict) -> str:
    ev = rec.get("ev")
    if ev in ("B", "E"):
        return (
            f"span {rec.get('span', '?')} "
            f"{'begin' if ev == 'B' else 'end'}"
            + (f" ({rec['dur_s']:.4f}s)" if "dur_s" in rec else "")
        )
    if ev == "req":
        phase = {"b": "begin", "n": "", "e": "end"}.get(
            rec.get("ph"), rec.get("ph", "?")
        )
        return f"req {rec.get('name', '?')} {phase}".rstrip()
    if ev == "journal":
        extra = rec.get("status") or ""
        return f"journal {rec.get('op', '?')} {extra}".rstrip()
    tail = (
        rec.get("op") or rec.get("status") or rec.get("state")
        or rec.get("kind") or ""
    )
    return f"{ev} {tail}".rstrip()


def _entry(ts, src, what, record=None) -> dict:
    out = {"ts": float(ts), "src": str(src), "what": str(what)}
    if record is not None:
        out["record"] = record
    return out


def trace_timeline(
    trace_id: str,
    events=(),
    journals=(),
    tsdb_dir=None,
    extra_jsonl=(),
    drops=None,
) -> list:
    """Join every evidence stream on one ``trace_id`` into a single
    chronological timeline — the post-mortem question ("what happened
    to request X?") as one call.

    ``events`` entries may be events.jsonl files OR flight dumps (a
    killed host's ring replays through the same reader). ``journals``
    are serving journal.jsonl files: the accept carrying the trace_id
    binds its request id, and that request's token stream is summarized
    (first/last journaled token) rather than listed. ``tsdb_dir``
    surfaces collector samples whose exemplars name the trace;
    ``extra_jsonl`` (alerts.jsonl / notifications.jsonl) surfaces any
    record that mentions it. Entries are ``{ts, src, what[, record]}``,
    sorted by ts."""
    from progen_tpu_torch.telemetry.trace import iter_events_any, iter_jsonl

    tid = str(trace_id)
    timeline: list = []

    for path in events:
        recs = list(iter_events_any(path, drops))
        req_ids = {
            str(r["req"]) for r in recs
            if r.get("trace_id") == tid and r.get("req") is not None
        }
        src = Path(path).name
        for r in recs:
            ts = r.get("ts")
            if ts is None:
                continue
            if r.get("trace_id") == tid or (
                r.get("ev") in ("req", "journal")
                and str(r.get("req")) in req_ids
            ):
                timeline.append(_entry(ts, src, _describe(r), r))

    for path in journals:
        recs = list(iter_jsonl(path, drops))
        req_ids = {
            str(r["req"]) for r in recs
            if r.get("op") == "accept" and r.get("trace_id") == tid
            and r.get("req") is not None
        }
        src = Path(path).name
        tokens: dict = {}  # req -> [n, (ts0, i0), (ts1, i1)]
        for r in recs:
            if r.get("ev") != "journal" or str(r.get("req")) not in req_ids:
                continue
            ts = r.get("ts")
            if ts is None:
                continue
            if r.get("op") == "token":
                slot = tokens.setdefault(str(r["req"]), [0, None, None])
                slot[0] += 1
                mark = (float(ts), int(r.get("index", -1)))
                if slot[1] is None:
                    slot[1] = mark
                slot[2] = mark
            else:
                timeline.append(_entry(ts, src, _describe(r), r))
        for req, (n, first, last) in tokens.items():
            timeline.append(_entry(
                first[0], src,
                f"journal token first (req {req}, index {first[1]})",
            ))
            if n > 1:
                timeline.append(_entry(
                    last[0], src,
                    f"journal token last (req {req}, index {last[1]}, "
                    f"{n} journaled)",
                ))

    if tsdb_dir is not None:
        from progen_tpu_torch.telemetry.tsdb import TsdbReader

        seen_ex = set()  # same exemplar rides every later scrape too
        for r in TsdbReader(tsdb_dir).read(drops):
            if r.get("ev") != "sample":
                continue
            for fam, tv in (r.get("timings") or {}).items():
                for ex in tv.get("exemplars") or []:
                    key = (r.get("source"), fam, ex.get("value"))
                    if ex.get("trace_id") == tid and key not in seen_ex:
                        seen_ex.add(key)
                        timeline.append(_entry(
                            r.get("ts", 0.0), "tsdb",
                            f"exemplar {fam}={ex.get('value')} "
                            f"(source {r.get('source', '?')})",
                        ))

    for path in extra_jsonl:
        src = Path(path).name
        for r in iter_jsonl(path, drops):
            ts = r.get("ts")
            if ts is None:
                continue
            if tid in json.dumps(r):
                timeline.append(_entry(ts, src, _describe(r), r))

    timeline.sort(key=lambda e: e["ts"])
    return timeline
