"""Seeded inputs for the tests that hold the port's telemetry back end
(``progen_tpu_torch/telemetry/``, ``fleet/autoscaler.py`` and the three
CLIs) against the JAX package's copies: the same records, expositions
and policies go through both, and the outputs must be equal. Not a test
module: the test files import it (it imports neither package)."""

import json
import os
from pathlib import Path

import numpy as np

SPAN_NAMES = ("train/step", "ckpt/save", "serve/prefill", "serve/decode",
              "data/read")
INSTANTS = ("retry", "anomaly", "stall", "chaos", "clock_beacon",
            "request_rejected", "reload", "route", "flight", "profile")


def span_stream(seed: int, host: int = 0, n: int = 24, t0: float = 1000.0,
                skew: float = 0.0, threads: int = 2) -> list:
    """One process's events.jsonl records: nested B/E span pairs on a few
    threads, instants (retries inside spans, chaos, beacons), goodput
    and slot-occupancy records and one request's async lifecycle, all on
    a clock ``skew`` seconds off true time."""
    rng = np.random.default_rng(seed)
    out, t, sid = [], t0 + skew, 0
    for step in range(n):
        tid = int(rng.integers(threads)) + 1
        name = SPAN_NAMES[int(rng.integers(len(SPAN_NAMES)))]
        dur = float(rng.uniform(0.01, 0.2))
        head = {"span": name, "id": sid, "pid": host, "tid": tid,
                "thread": f"t{tid}"}
        out.append({"ev": "B", **head, "ts": round(t, 6), "step": step})
        if rng.random() < 0.3:
            out.append({"ev": "retry", "label": "ckpt/io/meta_write",
                        "attempt": 1, "ts": round(t + dur / 2, 6),
                        "pid": host})
        out.append({"ev": "E", **head, "ts": round(t + dur, 6),
                    "dur_s": round(dur, 6), "step": step})
        out.append({"ev": "clock_beacon", "ts": round(t + dur, 6),
                    "step": step, "pid": host})
        ev = INSTANTS[int(rng.integers(len(INSTANTS)))]
        if ev != "clock_beacon":
            out.append({"ev": ev, "ts": round(t + dur + 0.001, 6),
                        "pid": host, "op": "x", "hit": step})
        out.append({"ev": "slots", "ts": round(t + dur, 6), "pid": host,
                    "in_use": int(rng.integers(4)), "free": 4})
        t += dur + float(rng.uniform(0.0, 0.05))
        sid += 1
    out += request_lifecycle(f"r-{seed}-{host}", host, t0 + skew + 0.5)
    out.append({"ev": "goodput_host", "ts": round(t, 6), "host": host,
                "pid": host, "wall_s": 4.0, "bucket_s/step": 3.0 - host,
                "bucket_s/other": 1.0 + host,
                "goodput_pct": 75.0 - 25 * host, "coverage_pct": 75.0})
    return out


def request_lifecycle(rid: str, pid: int, t0: float) -> list:
    """The records the serving scheduler emits for one request."""
    return [
        {"ev": "req", "ph": "b", "name": "request", "req": rid,
         "ts": t0, "pid": pid, "length": 16},
        {"ev": "req", "ph": "b", "name": "queued", "req": rid,
         "ts": t0, "pid": pid},
        {"ev": "req", "ph": "e", "name": "queued", "req": rid,
         "ts": t0 + 0.01, "pid": pid},
        {"ev": "req", "ph": "b", "name": "prefill", "req": rid,
         "ts": t0 + 0.01, "pid": pid, "slot": 2},
        {"ev": "req", "ph": "e", "name": "prefill", "req": rid,
         "ts": t0 + 0.05, "pid": pid},
        {"ev": "req", "ph": "b", "name": "decode", "req": rid,
         "ts": t0 + 0.05, "pid": pid, "slot": 2},
        {"ev": "req", "ph": "n", "name": "first_token", "req": rid,
         "ts": t0 + 0.06, "pid": pid},
        {"ev": "req", "ph": "e", "name": "decode", "req": rid,
         "ts": t0 + 0.20, "pid": pid},
        {"ev": "req", "ph": "e", "name": "request", "req": rid,
         "ts": t0 + 0.20, "pid": pid, "n_generated": 8},
    ]


def fleet_streams(trace: str = "t9:1") -> tuple:
    """Router + two replicas, all stamped pid 0 (one machine): the
    request goes to replica A, which dies midstream, and is handed to B."""

    def req(ph, rid, name, ts, **attrs):
        return {"ev": "req", "ph": ph, "req": rid, "name": name,
                "ts": ts, "pid": 0, "trace_id": trace, **attrs}

    router = [
        req("b", "q1-a", "request", 10.00, id="a"),
        req("b", "q1-a", "queued", 10.00),
        req("e", "q1-a", "queued", 10.05),
        req("b", "q1-a", "dispatched", 10.05, replica=0, hop=1),
        req("e", "q1-a", "dispatched", 11.00),
        req("b", "q1-a", "dispatched", 11.00, replica=1, hop=2,
            resumed=True),
        req("e", "q1-a", "dispatched", 12.00),
        req("e", "q1-a", "request", 12.00, status="ok"),
        {"ev": "route", "status": "dispatched", "replica": 0, "ts": 10.05,
         "pid": 0},
        {"ev": "route", "status": "replica_down", "replica": 0,
         "ts": 10.99, "pid": 0},
        {"ev": "route", "status": "handoff", "from": 0, "to": 1,
         "ts": 11.0, "pid": 0},
    ]
    rep_a = [req("b", "7:q1-a", "request", 10.06),
             req("b", "7:q1-a", "prefill", 10.10)]
    rep_b = [req("b", "8:q1-a", "request", 11.02, resumed=True),
             req("e", "8:q1-a", "request", 11.90, status="ok")]
    return router, rep_a, rep_b


def write_jsonl(path, records, torn: bool = False) -> Path:
    """Records as JSON lines; ``torn`` appends a half-written last line
    and a garbage line, as a SIGKILL mid-write leaves."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        if torn:
            f.write("not json\n")
            f.write('{"ev": "B", "span": "to')
    return path


def metrics_rows(seed: int, n: int = 30, t0: float = 1000.0,
                 prefix: str = "serve/", dt: float = 10.0) -> list:
    """A metrics.jsonl stream: cumulative counters and latency
    quantiles that drift upward, so an SLO over them burns."""
    rng = np.random.default_rng(seed)
    rows, done, sub, rej = [], 0, 0, 0
    for i in range(n):
        sub += int(rng.integers(5, 10))
        rej += int(rng.integers(0, 2))
        done = sub - rej
        ttft = 0.5 + 2.5 * i / n + float(rng.uniform(0, 0.3))
        rows.append({
            "_time": t0 + dt * i, "_step": i,
            f"{prefix}requests_submitted": sub,
            f"{prefix}requests_rejected": rej,
            f"{prefix}requests_completed": done,
            f"{prefix}replicas_up": float(i % 7 != 3),
            f"{prefix}queue_depth": float(rng.integers(0, 9)),
            f"{prefix}ttft_s_count": i + 1,
            f"{prefix}ttft_s_p50_s": round(ttft / 2, 6),
            f"{prefix}ttft_s_p95_s": round(ttft, 6),
            f"{prefix}ttft_s_p99_s": round(ttft * 1.2, 6),
            f"{prefix}latency_s_count": i + 1,
            f"{prefix}latency_s_p99_s": round(ttft * 8, 6),
        })
    return rows


def serving_prom(metrics_cls, text_fn, seed: int, completed: int,
                 queue: int, ttfts=None, trace_ids=None,
                 prefix: str = "progen_serve_") -> str:
    """An exposition written by ``text_fn`` (a package's
    ``prometheus_text``) over a ``metrics_cls`` (its ``ServingMetrics``)."""
    rng = np.random.default_rng(seed)
    m = metrics_cls()
    m.inc("requests_completed", completed)
    m.inc("requests_submitted", completed + int(rng.integers(0, 3)))
    m.inc("decode_tokens", 16 * completed)
    m.set_gauge("queue_depth", queue)
    m.set_gauge("slots_in_use", int(rng.integers(0, 2)))
    m.set_gauge("slots_total", 1)
    for i, v in enumerate(ttfts if ttfts is not None
                          else rng.uniform(0.05, 0.5, 6)):
        tid = trace_ids[i % len(trace_ids)] if trace_ids else None
        m.observe("ttft_s", float(v), trace_id=tid)
    return text_fn(m, prefix=prefix)


def write_prom(path, text: str, mtime: float) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    os.utime(path, (mtime, mtime))
    return path


FLEET_SLO_TOML = """
[windows]
short_s = 60
long_s = 600

[burn]
warn = 1.0
hot = 2.0
stale_after_s = 30

[objective_fleet_availability]
kind = "availability"
gauge = "replicas_live"
min_value = 2.0
target = 0.9

[objective_ttft_p95]
kind = "latency"
metric = "ttft_s"
quantile = "p95"
threshold_s = 0.3
"""

ROUTER_TOML = """
[alert_router]
severity_burning = "critical"

[route_ledger]
sink = "file"
min_severity = "info"

[route_hook]
sink = "webhook"
url = "{url}"
min_severity = "warning"
kinds = "staleness,slo_burn"
timeout_s = 5.0

[route_quiet]
sink = "file"
min_severity = "info"
silence_s = 900.0
"""

REPO_SLO = Path(__file__).resolve().parents[1] / "configs" / "serving" \
    / "slo.toml"


class Receiver:
    """In-process loopback remote-write and webhook receiver: records
    every POST body and path; ``fail_next`` answers 503 that many times
    first."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.bodies, self.paths, self.fail_next = [], [], 0
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                with outer.lock:
                    if outer.fail_next > 0:
                        outer.fail_next -= 1
                        self.send_response(503)
                        self.end_headers()
                        return
                    outer.bodies.append(body)
                    outer.paths.append(self.path)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def url(self, path: str = "/write") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def fleet_samples(make_sample, seed: int, ticks: int = 12,
                  sources=("router", "r0", "r1"), t0: float = 1000.0,
                  dt: float = 2.0) -> list:
    """``ev:"sample"`` records from ``make_sample`` (a package's) for a
    small fleet: counters that grow (and reset once, a respawn), queue
    gauges, ttft quantiles, one source going stale for a while."""
    rng = np.random.default_rng(seed)
    out, totals = [], {s: 0 for s in sources}
    for i in range(ticks):
        for s in sources:
            totals[s] += int(rng.integers(0, 5))
            if s == "r1" and i == ticks // 2:
                totals[s] = 1  # a respawn resets its counters
            up = not (s == "r1" and ticks // 3 <= i < ticks // 3 + 2)
            q = float(rng.uniform(0.05, 0.6))
            out.append(make_sample(
                ts=t0 + dt * i, source=s,
                role="router" if s == "router" else "replica", up=up,
                age_s=float(rng.uniform(0, 3)),
                counters={"requests_completed": float(totals[s]),
                          "decode_tokens": float(16 * totals[s])},
                gauges={"queue_depth": float(rng.integers(0, 6)),
                        "slots_in_use": float(rng.integers(0, 2)),
                        "replicas_live": 2.0, "replicas_total": 2.0},
                timings={"ttft_s": {"count": float(i + 1),
                                    "sum": q * (i + 1), "p50_s": q / 2,
                                    "p95_s": q, "p99_s": q * 1.3}}))
    return out
