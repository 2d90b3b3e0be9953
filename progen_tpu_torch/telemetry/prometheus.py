"""Prometheus text exposition (format 0.0.4): the port's copy of the JAX
package's ``telemetry/prometheus.py``, whole, so either package's output
reads the same on a dashboard.

Two transports, both fed by the same renderer:

  * ``write_prometheus(path, text)`` — atomic file write (tmp+rename)
    for the node-exporter *textfile collector* pattern; a scraper never
    reads a half-written exposition;
  * ``start_prometheus_server(render_fn)`` — a daemon-thread HTTP
    server answering every GET with a fresh render.

The renderer consumes the ``structured()`` form of a metrics source
(``serving.metrics.ServingMetrics``, ``telemetry.registry
.MetricsRegistry``), duck-typed: counters become ``counter`` samples
(named ``..._total``), gauges ``gauge``, and timings ``summary``
families with p50/p95/p99 quantile labels from the reservoir, each with
its ``_sum`` and ``_count`` (quantiles alone cannot be merged across
processes; the pair can).
"""

from __future__ import annotations

import http.server
import math
import os
import re
import threading
from pathlib import Path
from typing import Callable

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(prefix: str, raw: str) -> str:
    n = _NAME_RE.sub("_", f"{prefix}{raw}")
    return n if not n[:1].isdigit() else f"_{n}"


def escape_label_value(raw: str) -> str:
    """OpenMetrics label-value escape (backslash, quote, newline) — the
    exemplar ``trace_id`` is operator-influenced text riding inside a
    quoted label, so it must round-trip exactly."""
    return (
        str(raw)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    f = float(v)
    # Prometheus spellings for the non-finite values a gauge can carry
    # (an HBM limit on CPU is inf; a poisoned loss is NaN) — the int()
    # collapse below raises on both, so handle them first
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) else repr(f)


def prometheus_text(metrics, prefix: str = "progen_serve_") -> str:
    """Render a ServingMetrics (anything with ``structured()``) or an
    already-structured dict to Prometheus exposition text."""
    s = metrics.structured() if hasattr(metrics, "structured") else metrics
    lines = []
    for raw, v in sorted(s.get("counters", {}).items()):
        n = _name(prefix, raw + "_total")
        lines += [f"# TYPE {n} counter", f"{n} {_fmt(v)}"]
    gauges = dict(s.get("gauges", {}))
    # derived throughputs are gauges too (true rates, not sampled)
    gauges.update(s.get("derived", {}))
    for raw, v in sorted(gauges.items()):
        n = _name(prefix, raw)
        lines += [f"# TYPE {n} gauge", f"{n} {_fmt(v)}"]
    for raw, t in sorted(s.get("timings", {}).items()):
        base = raw[: -len("_s")] if raw.endswith("_s") else raw
        n = _name(prefix, base + "_seconds")
        lines.append(f"# TYPE {n} summary")
        # trace exemplars ride the quantile lines in OpenMetrics
        # `# {trace_id="..."} value` syntax: the worst observation on
        # the highest quantile, next-worst on the next, so a scrape of
        # "p99 is slow" carries the request ids that made it slow
        exemplars = list(t.get("exemplars") or [])
        qitems = sorted(t.get("quantiles", {}).items())
        ex_by_q = {
            q: exemplars[i]
            for i, (q, _) in enumerate(reversed(qitems))
            if i < len(exemplars)
        }
        for q, qv in qitems:
            line = f'{n}{{quantile="{q}"}} {_fmt(qv)}'
            ex = ex_by_q.get(q)
            if ex:
                tid = escape_label_value(ex.get("trace_id", ""))
                line += (
                    f' # {{trace_id="{tid}"}} '
                    f'{_fmt(ex.get("value", 0.0))}'
                )
            lines.append(line)
        lines.append(f"{n}_sum {_fmt(t['sum'])}")
        lines.append(f"{n}_count {_fmt(t['count'])}")
    return "\n".join(lines) + "\n"


def write_prometheus(path, text: str) -> None:
    """Atomic exposition-file write (textfile-collector contract)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class _Handler(http.server.BaseHTTPRequestHandler):
    render: Callable[[], str]  # set per-server via subclassing

    def do_GET(self):  # camelCase: BaseHTTPRequestHandler contract
        try:
            body = type(self).render().encode()
        except Exception as e:  # a render bug must not kill the server
            self.send_response(500)
            self.end_headers()
            self.wfile.write(repr(e).encode())
            return
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # scrapes are not log events
        pass


def start_prometheus_server(
    render_fn: Callable[[], str], port: int = 0, host: str = "127.0.0.1"
):
    """Serve ``render_fn()`` on every GET from a daemon thread. Returns
    the server; ``server.server_address[1]`` is the bound port (useful
    with ``port=0``), ``server.shutdown()`` stops it."""
    handler = type("_BoundHandler", (_Handler,), {"render": staticmethod(render_fn)})
    srv = http.server.ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    t = threading.Thread(
        target=srv.serve_forever, name="prometheus-exporter", daemon=True
    )
    t.start()
    return srv
