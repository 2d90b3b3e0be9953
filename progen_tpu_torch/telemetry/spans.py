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
passed down. With no sink configured, records are dropped.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch


def host_index() -> int:
    """This process's rank in an initialised process group, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


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
    """Span emitter. ``sink`` is any ``callable(dict)`` (an
    ``EventLog.emit``) or None (records dropped)."""

    def __init__(self, sink: Optional[Callable[[dict], None]] = None):
        self._sink = sink
        self._seq = itertools.count()

    def set_sink(self, sink: Optional[Callable[[dict], None]]) -> None:
        self._sink = sink

    def emit(self, record: dict) -> None:
        """Stamp the host and hand the record to the sink. A closed or
        broken sink is dropped rather than raised into the caller's
        loop."""
        sink = self._sink
        if sink is None:
            return
        record.setdefault("pid", host_index())
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
        self.emit({"ev": "B", **head, "ts": time.time(), **attrs})
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.emit({"ev": "E", **head, "ts": time.time(),
                       "dur_s": round(time.perf_counter() - t0, 6),
                       **attrs})


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
