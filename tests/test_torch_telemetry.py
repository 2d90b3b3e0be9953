"""The port's telemetry (``progen_tpu_torch/telemetry/``) on the CPU,
against the JAX package's.

Held exactly: the Prometheus text of a registry (and of the serving
metrics) byte for byte against ``progen_tpu.telemetry.prometheus_text``
for the same hypothesis-drawn sequence of ``inc``/``set_gauge``/
``observe`` calls, trace exemplars, NaN/Inf gauges and names to sanitise
included; the registry's snapshot and typed view and ``_Timing.merged``;
the goodput ledger's report, its per-process table and skew under the
same fake clock (the buckets summing to the wall clock). The JAX
package's cases of spans, the stall watchdog (firing, escalating with a
fake ``memory_stats_fn``), the HTTP exposition and the crash-safe sinks
run against the port; ``hbm_gauges`` is ``{}`` on the CPU.
"""

import io
import json
import math
import threading
import time
import urllib.request

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from progen_tpu import telemetry as jtel
from progen_tpu.serving.metrics import ServingMetrics as JServingMetrics
from progen_tpu.telemetry import goodput as jgoodput
from progen_tpu.telemetry.registry import _Timing as JTiming
from progen_tpu_torch import telemetry as ttel
from progen_tpu_torch.serving.metrics import ServingMetrics
from progen_tpu_torch.telemetry import (
    BUCKETS,
    EventLog,
    GoodputLedger,
    MetricsRegistry,
    StallWatchdog,
    Telemetry,
    goodput_skew,
    hbm_gauges,
    per_host_reports,
    prometheus_text,
    start_prometheus_server,
    step_print,
    write_prometheus,
)
from progen_tpu_torch.telemetry import goodput as tgoodput
from progen_tpu_torch.telemetry.registry import _Timing
from progen_tpu_torch.tracking import JsonlTracker

# names that need sanitising, one starting with a digit, and plain ones
NAMES = st.sampled_from(["retries", "step_s", "hbm/in use(gb)",
                         "weird-name.pct", "9lives", "goodput_pct",
                         "ttft_s", "latency", "a:b"])
VALUES = st.one_of(
    st.integers(-5, 10**6),
    st.floats(allow_nan=True, allow_infinity=True, width=64),
)
TRACES = st.one_of(st.none(), st.sampled_from(
    ["t-1", "t-2", 'quote"d', "back\\slash", "new\nline", "t-3"]))
CALL = st.one_of(
    st.tuples(st.just("inc"), NAMES, st.integers(0, 1000)),
    st.tuples(st.just("set_gauge"), NAMES, VALUES),
    st.tuples(st.just("observe"), NAMES,
              st.floats(0, 100, allow_nan=False), TRACES),
)
PREFIXES = st.sampled_from(["progen_train_", "progen_serve_", ""])


def _apply(reg, calls):
    for call in calls:
        if call[0] == "observe":
            reg.observe(call[1], call[2], trace_id=call[3])
        else:
            getattr(reg, call[0])(call[1], call[2])


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(calls=st.lists(CALL, max_size=40), prefix=PREFIXES)
def test_registry_exposition_is_byte_equal_to_jax(calls, prefix):
    ours, theirs = MetricsRegistry(), jtel.MetricsRegistry()
    _apply(ours, calls)
    _apply(theirs, calls)
    assert prometheus_text(ours, prefix=prefix) == \
        jtel.prometheus_text(theirs, prefix=prefix)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys()
    for k in a:  # NaN == NaN here
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


@settings(max_examples=40, deadline=None, derandomize=True)
@given(counts=st.lists(st.tuples(st.sampled_from(
           ["requests_completed", "decode_tokens", "prefill_tokens"]),
           st.integers(0, 500)), max_size=10),
       times=st.lists(st.tuples(st.sampled_from(
           ["decode_time_s", "prefill_time_s"]),
           st.floats(0, 5, allow_nan=False)), max_size=4),
       obs=st.lists(st.tuples(st.sampled_from(["ttft_s", "itl_s",
                                               "latency_s"]),
                              st.floats(0, 10, allow_nan=False), TRACES),
                    max_size=30),
       gauges=st.lists(st.tuples(st.sampled_from(["queue_depth",
                                                  "slots_busy"]), VALUES),
                       max_size=4))
def test_serving_exposition_is_byte_equal_to_jax(counts, times, obs,
                                                 gauges):
    ours, theirs = ServingMetrics(), JServingMetrics()
    for m in (ours, theirs):
        for name, n in counts:
            m.inc(name, n)
        for name, t in times:
            m.add_time(name, t)
        for name, v, tid in obs:
            m.observe(name, v, trace_id=tid)
        for name, v in gauges:
            m.set_gauge(name, v)
    assert prometheus_text(ours) == jtel.prometheus_text(theirs)
    assert json.dumps(ours.structured(), sort_keys=True) == \
        json.dumps(theirs.structured(), sort_keys=True)


def test_prometheus_nan_inf_and_names_as_jax():
    """The JAX package's formatting cases (``tests/test_telemetry.py``),
    byte for byte."""
    for s, prefix in (
            ({"counters": {}, "gauges": {"bad_loss": float("nan"),
                                         "hbm_limit": float("inf"),
                                         "neg": float("-inf")},
              "derived": {}, "timings": {}}, "progen_serve_"),
            ({"counters": {"hbm/in use(gb)": 1},
              "gauges": {"weird-name.pct": 2.5}, "derived": {},
              "timings": {}}, "progen_serve_"),
            ({"counters": {}, "gauges": {"9lives": 1}, "derived": {},
              "timings": {}}, "")):
        text = prometheus_text(s, prefix=prefix)
        assert text == jtel.prometheus_text(s, prefix=prefix)
    assert "progen_serve_bad_loss NaN" in prometheus_text(
        {"gauges": {"bad_loss": float("nan")}})
    assert "_9lives 1" in prometheus_text({"gauges": {"9lives": 1}},
                                          prefix="")


@settings(max_examples=30, deadline=None, derandomize=True)
@given(parts=st.lists(st.lists(st.tuples(st.floats(0, 50, allow_nan=False),
                                         TRACES), max_size=700),
                      min_size=1, max_size=3))
def test_timing_merge_and_exemplars_as_jax(parts):
    ours, theirs = [], []
    for obs in parts:
        a, b = _Timing(), JTiming()
        for v, tid in obs:
            a.observe(v, trace_id=tid)
            b.observe(v, trace_id=tid)
        assert a.stats() == b.stats() and a.exemplars() == b.exemplars()
        ours.append(a)
        theirs.append(b)
    m, j = _Timing.merged(ours), JTiming.merged(theirs)
    assert m.stats() == j.stats() and m.exemplars() == j.exemplars()


def test_registry_counters_gauges_timings_and_threads():
    reg = MetricsRegistry()
    reg.inc("retries", 0)  # declared: present at zero
    reg.inc("retries")
    reg.set_gauge("goodput_pct", 87.5)
    for i in range(100):
        reg.observe("step_s", 0.01 * (i + 1))
    text = prometheus_text(reg, prefix="progen_train_")
    assert "progen_train_retries_total 1" in text
    assert "progen_train_goodput_pct 87.5" in text
    assert 'progen_train_step_seconds{quantile="0.99"}' in text
    assert "progen_train_step_seconds_count 100" in text
    reg.reset()
    assert reg.snapshot() == {}
    threads = [threading.Thread(target=lambda: [reg.inc("n")
                                                for _ in range(1000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.snapshot()["n"] == 8000
    assert ttel.get_registry() is ttel.get_registry()


# --------------------------------------------------------------- goodput

def _clocked(mod, steps):
    t = {"now": 0.0}
    ledger = mod.GoodputLedger(clock=lambda: t["now"])
    for bucket, dur in steps:
        if bucket is None:
            t["now"] += dur
            continue
        with ledger.track(bucket) as tr:
            t["now"] += dur
        assert tr.seconds == pytest.approx(dur)
    return ledger


@settings(max_examples=50, deadline=None, derandomize=True)
@given(steps=st.lists(st.tuples(
    st.sampled_from(list(BUCKETS) + ["custom", None]),
    st.floats(0, 100, allow_nan=False)), max_size=20))
def test_goodput_report_equals_jax_under_a_fake_clock(steps):
    ours, theirs = _clocked(tgoodput, steps), _clocked(jgoodput, steps)
    rep = ours.report()
    assert rep == theirs.report()
    assert per_host_reports(ours) == [rep]
    assert goodput_skew([rep, theirs.report()]) == \
        jgoodput.goodput_skew([rep, theirs.report()])
    total = sum(v for k, v in rep.items() if k.startswith("bucket_s/"))
    assert total == pytest.approx(rep["wall_s"], abs=1e-3 * (1 + len(rep)))
    if rep["wall_s"] > 1:
        assert 100.0 * total / rep["wall_s"] == pytest.approx(100.0,
                                                              abs=0.5)


def test_goodput_buckets_sum_to_wallclock():
    ledger = _clocked(tgoodput, [
        ("compile", 5.0), ("step", 30.0), ("data", 2.0),
        ("checkpoint", 3.0), ("eval", 1.5), ("sample", 1.0), ("log", 0.5),
        (None, 2.0)])
    rep = ledger.report()
    total = sum(v for k, v in rep.items() if k.startswith("bucket_s/"))
    assert total == pytest.approx(rep["wall_s"], abs=1e-6)
    assert rep["bucket_s/other"] == pytest.approx(2.0)
    assert rep["goodput_pct"] == pytest.approx(100 * 30.0 / 45.0, abs=0.01)
    assert rep["coverage_pct"] == pytest.approx(100 * 43.0 / 45.0, abs=0.01)


def test_emit_per_host_goodput_one_record_per_process():
    ledger = _clocked(tgoodput, [("step", 3.0)])
    got = []
    reports = ttel.emit_per_host_goodput(ledger, emit=got.append)
    assert len(reports) == len(got) == 1
    assert got[0]["ev"] == "goodput_host" and got[0]["host"] == 0
    assert got[0]["goodput_pct"] == 100.0


# ----------------------------------------------------------------- spans

def test_span_records_and_open_recent_state(tmp_path):
    log = EventLog(tmp_path / "events.jsonl")
    tel = Telemetry(sink=log.emit)
    with tel.span("outer", step=7):
        with tel.span("inner"):
            assert [r["span"] for r in tel.open_spans()] == ["outer",
                                                            "inner"]
        assert [r["span"] for r in tel.open_spans()] == ["outer"]
    with pytest.raises(RuntimeError):
        with tel.span("doomed"):
            raise RuntimeError("boom")
    log.close()
    assert tel.open_spans() == []
    assert [r["span"] for r in tel.recent_spans()] == ["inner", "outer",
                                                       "doomed"]
    recs = [json.loads(ln) for ln in
            (tmp_path / "events.jsonl").read_text().splitlines()]
    assert [r["ev"] for r in recs] == ["B", "B", "E", "E", "B", "E"]
    assert recs[0]["step"] == recs[3]["step"] == 7
    assert all(r["pid"] == 0 for r in recs)
    with tel.span("survives"):  # a dead sink detaches, never raises
        pass
    assert tel.recent_spans()[-1]["span"] == "survives"


def test_step_print_format(capsys):
    step_print(42, "loss: 1.2345")
    out = capsys.readouterr().out
    assert "step 42]" in out and "loss: 1.2345" in out


def test_tracker_events_never_tear(tmp_path):
    tracker = JsonlTracker("p", "run", str(tmp_path))

    def emit(k):
        for i in range(200):
            tracker.log_event({"ev": "x", "k": k, "i": i, "pad": "y" * 300})

    threads = [threading.Thread(target=emit, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for i in range(100):
        tracker.log({"loss": float(i)}, step=i)
    for t in threads:
        t.join()
    tracker.finish()
    lines = (tmp_path / "p" / "run" / "events.jsonl").read_text() \
        .splitlines()
    assert len(lines) == 1200
    assert all(json.loads(ln)["ev"] == "x" for ln in lines)
    with pytest.raises(ValueError):
        tracker.log_event({"ev": "late"})


# -------------------------------------------------------------- watchdog

def test_watchdog_fires_with_stack_dump_and_spans():
    buf, tel, reports = io.StringIO(), Telemetry(), []
    with tel.span("train/step"):
        wd = StallWatchdog(0.2, file=buf, telemetry=tel,
                           on_stall=reports.append, poll_s=0.05)
        with wd:
            deadline = time.time() + 5.0
            while not wd.fired and time.time() < deadline:
                time.sleep(0.05)
    assert wd.fired and wd.fire_count == 1
    out = buf.getvalue()
    assert "stall-watchdog" in out and "train/step" in out
    assert "Thread" in out
    assert reports[0]["open_spans"][0]["span"] == "train/step"
    assert ttel.get_registry().snapshot()["stalls"] >= 1


def test_watchdog_quiet_while_beaten_and_rejects_zero():
    buf = io.StringIO()
    wd = StallWatchdog(0.4, file=buf, telemetry=Telemetry(), poll_s=0.05)
    with wd:
        for _ in range(12):
            wd.beat()
            time.sleep(0.05)
    assert not wd.fired and buf.getvalue() == ""
    with pytest.raises(ValueError):
        StallWatchdog(0)


def test_watchdog_escalates_with_memory_stats():
    buf, tel, records = io.StringIO(), Telemetry(), []
    tel.set_sink(records.append)
    fake_mem = [{"device": "0", "allocated_bytes.all.current": 123}]
    with tel.span("train/step"):
        wd = StallWatchdog(0.15, file=buf, telemetry=tel, poll_s=0.02,
                           escalate_after=2,
                           memory_stats_fn=lambda: fake_mem)
        with wd:
            deadline = time.time() + 5.0
            while wd.escalation_count == 0 and time.time() < deadline:
                time.sleep(0.02)
    assert wd.escalation_count >= 1 and wd.fire_count >= 2
    esc = [r for r in records if r.get("ev") == "stall_escalation"]
    assert esc[0]["memory_stats"] == fake_mem
    assert esc[0]["consecutive_reports"] == 2
    assert esc[0]["open_spans"][0]["span"] == "train/step"
    assert "ESCALATION" in buf.getvalue()


def test_watchdog_beat_resets_and_default_reports_once():
    wd = StallWatchdog(0.2, file=io.StringIO(), telemetry=Telemetry(),
                       poll_s=0.02, escalate_after=3)
    with wd:
        deadline = time.time() + 5.0
        while not wd.fired and time.time() < deadline:
            time.sleep(0.02)
        wd.beat()
        time.sleep(0.1)
    assert wd.escalation_count == 0
    wd = StallWatchdog(0.1, file=io.StringIO(), telemetry=Telemetry(),
                       poll_s=0.02)
    with wd:
        time.sleep(0.5)
    assert wd.fire_count == 1


def test_device_memory_stats_and_hbm_gauges_empty_on_the_cpu():
    from progen_tpu_torch.telemetry.watchdog import _device_memory_stats

    assert _device_memory_stats() == []
    assert hbm_gauges() == {}
    assert hbm_gauges("cpu") == {}


# ------------------------------------------------------------ exposition

def test_prometheus_file_and_http_server(tmp_path):
    reg = MetricsRegistry()
    reg.inc("retries", 2)
    path = tmp_path / "m" / "train.prom"
    write_prometheus(path, prometheus_text(reg, prefix="progen_train_"))
    assert path.read_text() == "# TYPE progen_train_retries_total " \
        "counter\nprogen_train_retries_total 2\n"
    assert not (tmp_path / "m" / "train.prom.tmp").exists()
    srv = start_prometheus_server(
        lambda: prometheus_text(reg, prefix="progen_train_"))
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    finally:
        srv.shutdown()
    assert body == path.read_text()
    assert ctype.startswith("text/plain; version=0.0.4")
