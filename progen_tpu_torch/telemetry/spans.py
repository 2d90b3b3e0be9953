"""Span API: context-manager tracing to an ``events.jsonl`` sink.

The port's copy of the JAX package's ``telemetry/spans.py``. A span is
one timed region of host code (``span("serve/prefill_chunk")``): on entry a
``B`` (begin) record goes to the sink, on exit an ``E`` (end) record
with the duration, so a ``B`` without its ``E`` is the phase a process
died in. Both records carry ``parent``, the id of the innermost span
open on the same thread when the span was entered (None at the top),
so the spans of one step group under its root.

Stamps come from ``time.time_ns()``, the clock of ``torch.profiler``'s
event timestamps: a record's ``ts`` (seconds) is the entry or exit
stamp, and ``dur_s`` their difference. While a profiler is running
the body also runs under ``torch.profiler.record_function``, so the
trace shows the span around the kernels it launched (the counterpart
of ``jax.named_scope``); without one the annotation is skipped, and a
span costs only its bookkeeping. A span opened before a profiler
starts is not annotated.

``span(name, wait=True)`` marks a region where the host waits for the
card: a ``bool()``, ``.item()`` or ``.cpu()`` of a device tensor, or a
copy from pageable memory.

The module-level ``span()``/``configure()`` pair drives one
process-global ``Telemetry``, so callees open spans without a handle
passed down. With no sink configured, records are dropped, but the
in-memory state is kept: the open spans, and a ring of the last
``RING_SPANS`` closed ones (``Closed`` tuples) that the stall watchdog
(``telemetry/watchdog.py``) and the benchmark's per-layer readers read.
Every span's entry calls the hooks in ``SPAN_ENTRY_HOOKS`` with its
name: the fault injector (``resilience/chaos.py``) registers there.
``step_print`` is the train loop's step-stamped console line.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch


def host_index() -> int:
    """This process's rank in an initialised process group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# closed spans kept in memory: a 51 s benchmark window closes about
# 2,000 spans, so the ring holds many windows
RING_SPANS = 32768


class Closed(NamedTuple):
    """One closed span in the ring: stamps in ``time.time_ns()``."""

    name: str
    id: int
    parent: Optional[int]
    tid: int
    t0_ns: int
    t1_ns: int
    wait: bool


# span-entry hooks: called with the span name after the B record is
# emitted, inside the span's try block, so a hook that raises reaches the
# span's caller while the E record still closes the span. The chaos
# injector registers here; an empty list is a no-op.
SPAN_ENTRY_HOOKS: list = []

# emit taps: called with every record that reaches Telemetry.emit, before
# the sink check, so a tap sees records on a process without a sink too.
# The flight recorder (telemetry/flight.py) registers here. A tap runs on
# the training and serving hot path; one that raises is swallowed. An
# empty list is a no-op.
EMIT_TAPS: list = []


class EventLog:
    """Crash-safe append-only JSONL sink: one record per line, flushed
    per line, so a SIGKILL loses at most the line being written."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = self.path.open("a")
        self._lock = threading.Lock()

    def emit(self, record: dict) -> None:
        # write + flush is one critical section, so lines stay whole
        with self._lock:
            if self._f.closed:
                return
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class Telemetry:
    """Span emitter and the in-memory state of open and closed spans.
    ``sink`` is any ``callable(dict)`` (an ``EventLog.emit``, a
    ``JsonlTracker.log_event``) or None (records dropped, state kept)."""

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 ring_spans: int = RING_SPANS):
        self._sink = sink
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._open: dict = {}
        self._ring: deque = deque(maxlen=ring_spans)
        self._local = threading.local()  # .stack: ids of open spans
        self.dropped = 0  # closed spans pushed out of the ring

    def set_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        self._sink = sink

    def emit(self, record: dict) -> None:
        """Stamp the host and hand the record to the sink. A closed or
        broken sink is dropped rather than raised into the caller's
        loop."""
        record.setdefault("pid", host_index())
        for tap in EMIT_TAPS:
            try:
                tap(record)
            except Exception:
                pass
        sink = self._sink
        if sink is None:
            return
        try:
            sink(record)
        except (OSError, ValueError):
            self._sink = None

    @contextlib.contextmanager
    def span(self, name: str, wait: bool = False, **attrs):
        """``B`` on entry, ``E`` with ``dur_s`` on exit, also when the
        body raises. ``wait``: the body is the host waiting for the
        card."""
        t0 = time.time_ns()
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        thread = threading.current_thread()
        sid = next(self._seq)
        parent = stack[-1] if stack else None
        head = {"span": name, "id": sid, "parent": parent,
                "tid": thread.ident, "thread": thread.name}
        begin = {"ev": "B", **head, "ts": t0 / 1e9, **attrs}
        stack.append(sid)
        with self._lock:
            self._open[sid] = begin
        self.emit(begin)
        try:
            for hook in SPAN_ENTRY_HOOKS:
                hook(name)
            if torch.autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            t1 = time.time_ns()
            # off the entering thread's stack, also when another thread
            # closes the span
            if stack and stack[-1] == sid:
                stack.pop()
            elif sid in stack:
                stack.remove(sid)
            end = {"ev": "E", **head, "ts": t1 / 1e9,
                   "dur_s": round((t1 - t0) / 1e9, 6), **attrs}
            closed = Closed(name, sid, parent, thread.ident, t0, t1, wait)
            with self._lock:
                self._open.pop(sid, None)
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(closed)
            self.emit(end)

    def open_spans(self) -> list:
        """Spans inside their body now: where the process is."""
        with self._lock:
            return sorted(self._open.values(), key=lambda r: r["id"])

    def recent_spans(self, n: int = 16) -> list:
        """The last ``n`` closed spans, oldest first, as records with
        ``span``, ``ts`` (exit) and ``dur_s``."""
        with self._lock:
            last = list(itertools.islice(reversed(self._ring), n))
        return [{"span": c.name, "ts": c.t1_ns / 1e9,
                 "dur_s": round((c.t1_ns - c.t0_ns) / 1e9, 6)}
                for c in reversed(last)]

    def closed_spans(self) -> list:
        """The ring of closed spans, oldest (first closed) first;
        ``dropped`` counts those it no longer holds."""
        with self._lock:
            return list(self._ring)


_GLOBAL = Telemetry()


def get_telemetry() -> Telemetry:
    return _GLOBAL


def configure(sink: Optional[Callable[[dict], None]] = None,
              path=None) -> Telemetry:
    """Point the process-global telemetry at a sink. ``path`` opens an
    ``EventLog`` there; ``sink`` wins when both are given; neither
    detaches (records drop)."""
    if sink is None and path is not None:
        sink = EventLog(path).emit
    _GLOBAL.set_sink(sink)
    return _GLOBAL


def span(name: str, wait: bool = False, **attrs):
    """A span on the process-global Telemetry."""
    return _GLOBAL.span(name, wait, **attrs)


def step_print(step, msg: str) -> None:
    """Step-stamped console line, ``[HH:MM:SS step N] msg``: the tracker
    stream carries ``_time``/``_step``, the console the same two."""
    print(f"[{time.strftime('%H:%M:%S')} step {step}] {msg}", flush=True)
