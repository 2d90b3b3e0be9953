"""Span API: context-manager tracing to an ``events.jsonl`` sink.

The port's copy of the JAX package's ``telemetry/spans.py``. A span is
one timed region of host code (``span("serve/prefill_chunk")``): on entry a
``B`` (begin) record goes to the sink, on exit an ``E`` (end) record
with the duration, so a ``B`` without its ``E`` is the phase a process
died in. The body also runs under ``torch.profiler.record_function``, so
a profiler trace shows the span around the kernels it launched (the
counterpart of ``jax.named_scope``).

The module-level ``span()``/``configure()`` pair drives one
process-global ``Telemetry``, so callees open spans without a handle
passed down. With no sink configured, records are dropped, but the
in-memory state of open and recently closed spans is kept: it is what
the stall watchdog (``telemetry/watchdog.py``) reports. Every span's
entry calls the hooks in ``SPAN_ENTRY_HOOKS`` with its name: the fault
injector (``resilience/chaos.py``) registers there. ``step_print`` is
the train loop's step-stamped console line.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

import torch


def host_index() -> int:
    """This process's rank in an initialised process group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# span-entry hooks: called with the span name after the B record is
# emitted, inside the span's try block, so a hook that raises reaches the
# span's caller while the E record still closes the span. The chaos
# injector registers here; an empty list is a no-op.
SPAN_ENTRY_HOOKS: list = []


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
    """Span emitter and the in-memory state of open and recent spans.
    ``sink`` is any ``callable(dict)`` (an ``EventLog.emit``, a
    ``JsonlTracker.log_event``) or None (records dropped, state kept)."""

    def __init__(self, sink: Optional[Callable[[dict], None]] = None,
                 max_recent: int = 64):
        self._sink = sink
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._open: dict = {}
        self._recent: deque = deque(maxlen=max_recent)

    def set_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        self._sink = sink

    def emit(self, record: dict) -> None:
        """Stamp the host and hand the record to the sink. A closed or
        broken sink is dropped rather than raised into the caller's
        loop."""
        record.setdefault("pid", host_index())
        sink = self._sink
        if sink is None:
            return
        try:
            sink(record)
        except (OSError, ValueError):
            self._sink = None

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """``B`` on entry, ``E`` with ``dur_s`` on exit, also when the
        body raises."""
        thread = threading.current_thread()
        head = {"span": name, "id": next(self._seq), "tid": thread.ident,
                "thread": thread.name}
        begin = {"ev": "B", **head, "ts": time.time(), **attrs}
        with self._lock:
            self._open[head["id"]] = begin
        self.emit(begin)
        t0 = time.perf_counter()
        try:
            for hook in SPAN_ENTRY_HOOKS:
                hook(name)
            with torch.profiler.record_function(name):
                yield
        finally:
            end = {"ev": "E", **head, "ts": time.time(),
                   "dur_s": round(time.perf_counter() - t0, 6), **attrs}
            with self._lock:
                self._open.pop(head["id"], None)
                self._recent.append(end)
            self.emit(end)

    def open_spans(self) -> list:
        """Spans inside their body now: where the process is."""
        with self._lock:
            return sorted(self._open.values(), key=lambda r: r["id"])

    def recent_spans(self, n: int = 16) -> list:
        """The last ``n`` closed spans, oldest first."""
        with self._lock:
            return list(self._recent)[-n:]


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


def span(name: str, **attrs):
    """A span on the process-global Telemetry."""
    return _GLOBAL.span(name, **attrs)


def step_print(step, msg: str) -> None:
    """Step-stamped console line, ``[HH:MM:SS step N] msg``: the tracker
    stream carries ``_time``/``_step``, the console the same two."""
    print(f"[{time.strftime('%H:%M:%S')} step {step}] {msg}", flush=True)
