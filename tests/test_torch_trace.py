"""The port's ``telemetry/trace.py`` against the JAX package's: the same
seeded event streams (spans on several threads and hosts, retries
inside and outside spans, instants, slot counters, request lifecycles,
metrics rows, torn lines) give the same Perfetto JSON, the same drop
counts and the same records through ``iter_events_any``, also when the
stream is a flight dump sealed by the other package."""

import json

import pytest

from progen_tpu.telemetry import flight as jax_flight
from progen_tpu.telemetry import trace as jax_trace
from progen_tpu_torch.telemetry import flight as pt_flight
from progen_tpu_torch.telemetry import trace as pt_trace
from torch_telemetry_cases import (
    fleet_streams,
    metrics_rows,
    request_lifecycle,
    span_stream,
    write_jsonl,
)

SCENARIOS = {
    "one_host": lambda: span_stream(0),
    "two_hosts": lambda: span_stream(1) + span_stream(2, host=1, skew=0.3),
    "four_threads": lambda: span_stream(3, threads=4, n=40),
    "requests": lambda: (request_lifecycle("a", 0, 10.0)
                         + request_lifecycle("b", 0, 10.1)[:5]),
    "fleet": lambda: sum(fleet_streams(), []),
    "unclosed_span": lambda: span_stream(4)[:-7] + [
        {"ev": "B", "span": "ckpt/save", "id": 99, "ts": 2000.0, "pid": 0,
         "tid": 1, "thread": "t1"},
        {"ev": "retry", "label": "data/read", "ts": 2000.5, "pid": 0}],
    "malformed_req": lambda: [
        {"ev": "req", "ph": "b", "ts": 1.0, "pid": 0},
        {"ev": "req", "ph": "q", "name": "x", "req": "r", "ts": 1.1},
        {"ev": "req", "ph": "e", "name": "x", "req": "r", "ts": 1.2,
         "pid": 0}] + request_lifecycle("ok", 0, 2.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_trace_matches(name):
    records = SCENARIOS[name]()
    got = pt_trace.build_trace([dict(r) for r in records])
    want = jax_trace.build_trace([dict(r) for r in records])
    assert got == want
    assert got["traceEvents"]


@pytest.mark.parametrize("seed", [0, 5])
def test_build_trace_with_metrics_rows_matches(seed):
    records = span_stream(seed)
    rows = metrics_rows(seed, n=8, prefix="")
    for r in rows:
        r.update(step_ms=12.5 + r["_step"], mfu=0.3, goodput_pct=80.0,
                 tokens_per_sec_per_chip=1e4, **{"hbm/in_use_gb": 3.0})
    got = pt_trace.build_trace([dict(r) for r in records],
                               metrics=[dict(r) for r in rows])
    want = jax_trace.build_trace([dict(r) for r in records],
                                 metrics=[dict(r) for r in rows])
    assert got == want


@pytest.mark.parametrize("torn", [False, True])
def test_export_trace_file_matches(tmp_path, torn):
    events = write_jsonl(tmp_path / "events.jsonl", span_stream(7), torn)
    metrics = write_jsonl(tmp_path / "metrics.jsonl",
                          metrics_rows(7, n=5, prefix=""), torn)
    got = pt_trace.export_trace(events, tmp_path / "pt.json",
                                metrics_path=metrics)
    want = jax_trace.export_trace(events, tmp_path / "jax.json",
                                  metrics_path=metrics)
    assert got == want
    assert json.loads((tmp_path / "pt.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    assert got.get("progenDroppedLines", 0) == (4 if torn else 0)


def test_iter_jsonl_and_drops_match(tmp_path):
    path = write_jsonl(tmp_path / "e.jsonl", span_stream(8), torn=True)
    with path.open("a") as f:
        f.write("\n[1, 2]\n")
    pd, jd = pt_trace.LineDrops(), jax_trace.LineDrops()
    assert list(pt_trace.iter_jsonl(path, pd)) == \
        list(jax_trace.iter_jsonl(path, jd))
    assert pd.count == jd.count == 3


@pytest.mark.parametrize("sealer", ["port", "jax"])
def test_iter_events_any_reads_a_dump_of_either_package(tmp_path, sealer):
    seal = (pt_flight if sealer == "port" else jax_flight).seal
    records = span_stream(9)
    path = tmp_path / "flight-0-1000.json"
    path.write_text(json.dumps(seal({"flight": 1, "records": records})))
    pd, jd = pt_trace.LineDrops(), jax_trace.LineDrops()
    got = list(pt_trace.iter_events_any(path, pd))
    assert got == list(jax_trace.iter_events_any(path, jd)) == records
    assert pd.count == jd.count == 0
    # a tampered dump counts one drop in both, never raises
    doc = json.loads(path.read_text())
    doc["payload"]["records"][0]["ts"] += 1
    path.write_text(json.dumps(doc))
    assert list(pt_trace.iter_events_any(path, pd)) == []
    assert list(jax_trace.iter_events_any(path, jd)) == []
    assert pd.count == jd.count == 1


def test_instant_alphabet_matches():
    assert pt_trace.INSTANT_EVENTS == jax_trace.INSTANT_EVENTS
