"""Telemetry for the port: copies of the JAX package's ``telemetry/``
modules that the train loop, serving and the workloads use.

  * ``span("ckpt/save")`` — begin/end records to a crash-safe
    ``events.jsonl``, run under ``torch.profiler.record_function`` so a
    profiler trace carries the same names (``spans.py``);
  * ``GoodputLedger`` — the train loop's wall clock by bucket
    (``goodput.py``), with the per-process table and its skew;
  * ``StallWatchdog`` — all-thread stacks and the open spans when no step
    completes within a deadline (``watchdog.py``);
  * ``hbm_gauges`` — the card's allocator occupancy (``hbm.py``);
  * ``prometheus_text`` / ``write_prometheus`` /
    ``start_prometheus_server`` — text exposition of any ``structured()``
    source (``prometheus.py``);
  * ``MetricsRegistry`` / ``get_registry`` — the process-wide counters,
    gauges and timings (``registry.py``).

``trace.py`` holds the JSONL reader the serving journal uses; the JAX
package's trace export, stitching and SLO modules are not ported yet.
"""

from progen_tpu_torch.telemetry.goodput import (
    BUCKETS,
    GoodputLedger,
    emit_per_host_goodput,
    goodput_skew,
    per_host_reports,
)
from progen_tpu_torch.telemetry.hbm import hbm_gauges
from progen_tpu_torch.telemetry.prometheus import (
    prometheus_text,
    start_prometheus_server,
    write_prometheus,
)
from progen_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from progen_tpu_torch.telemetry.spans import (
    EventLog,
    Telemetry,
    configure,
    get_telemetry,
    host_index,
    span,
    step_print,
)
from progen_tpu_torch.telemetry.watchdog import StallWatchdog

__all__ = [
    "BUCKETS",
    "GoodputLedger",
    "per_host_reports",
    "goodput_skew",
    "emit_per_host_goodput",
    "EventLog",
    "Telemetry",
    "configure",
    "get_telemetry",
    "host_index",
    "span",
    "step_print",
    "StallWatchdog",
    "hbm_gauges",
    "prometheus_text",
    "write_prometheus",
    "start_prometheus_server",
    "MetricsRegistry",
    "get_registry",
]
