"""Telemetry for the port: copies of the JAX package's ``telemetry/``
modules.

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

  * ``build_trace`` / ``export_trace`` — events.jsonl to Chrome Trace
    Event / Perfetto JSON (``trace.py``, the ``export-trace`` command);
  * ``stitch_trace`` / ``clock_offsets`` / ``emit_clock_beacon`` — N
    processes' event files to one trace on a common corrected clock
    (``stitch.py``);
  * ``slo`` — objectives from TOML, multi-window burn rates and the
    slo-report gate; ``tsdb``, ``collector``, ``remote_write``,
    ``alerts``, ``alert_router`` and ``console`` — the fleet metrics
    back end behind ``cli.collector`` and ``cli.top``;
  * ``flight`` — the flight recorder and the ``profile.pin`` profiler
    windows.
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
from progen_tpu_torch.telemetry.slo import (
    SloConfig,
    SloWatch,
    evaluate as evaluate_slos,
    exit_code as slo_exit_code,
    load_objectives,
)
from progen_tpu_torch.telemetry.spans import (
    EventLog,
    Telemetry,
    configure,
    get_telemetry,
    host_index,
    span,
    step_print,
)
from progen_tpu_torch.telemetry.stitch import (
    clock_offsets,
    emit_clock_beacon,
    stitch_streams,
    stitch_trace,
)
from progen_tpu_torch.telemetry.trace import build_trace, export_trace
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
    "build_trace",
    "export_trace",
    "clock_offsets",
    "emit_clock_beacon",
    "stitch_streams",
    "stitch_trace",
    "SloConfig",
    "SloWatch",
    "evaluate_slos",
    "slo_exit_code",
    "load_objectives",
]
