"""The port's ``telemetry/flight.py`` against the JAX package's.

  * the seal: a dump sealed by either package verifies under the other;
    a tampered or torn one is refused by both with the same message;
  * the recorder: the same records through ``Telemetry.emit`` fire the
    same auto-dump edges (chaos kill, stall escalation, anomaly
    rollback, SLO ``burning``) and leave the same ring; a SIGKILL at the
    ``flight/dump`` chaos site leaves no file and no ``.tmp``;
  * the profile pin: the JAX fake-profiler cases run against both
    watchers in lockstep (same acks, same profiler calls), and the
    port's real ``torch.profiler`` window on the CPU writes a Chrome
    trace and acks ``started`` then ``stopped``;
  * ``trace_timeline`` joins the same streams alike, and a ``cli.serve``
    SIGKILLed by chaos mid-decode leaves a black box that the JAX
    ``verify_dump`` accepts and that reconstructs the killed request in
    both packages alike.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from progen_tpu.telemetry import flight as jax_flight
from progen_tpu.telemetry import slo as jax_slo
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch import telemetry as pt_telemetry
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.telemetry import flight as pt_flight
from progen_tpu_torch.telemetry import slo as pt_slo
from progen_tpu_torch.telemetry.alerts import AlertSink
from progen_tpu_torch.training.step import init_train_state
from torch_telemetry_cases import span_stream, write_jsonl

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"port": pt_flight, "jax": jax_flight}


@pytest.fixture(autouse=True)
def _clean_global_recorder():
    yield
    pt_flight.disarm()
    pt_telemetry.configure()


# ------------------------------------------------------------- the seal


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_a_dump_sealed_by_one_verifies_under_the_other(tmp_path, writer,
                                                       reader):
    rec = PACKAGES[writer].FlightRecorder(tmp_path, ring=8,
                                          clock=lambda: 42.0, host=0)
    for r in span_stream(1, n=6):
        rec.tap(r)
    path = rec.dump("test", note="n")
    payload = PACKAGES[reader].verify_dump(path)
    assert payload["reason"] == "test" and payload["note"] == "n"
    assert payload["truncated"] == len(span_stream(1, n=6)) - 8
    assert PACKAGES[reader].dump_records(path) == payload["records"]
    assert PACKAGES[reader].find_dumps(tmp_path) == [path]


@pytest.mark.parametrize("damage", ["tamper", "torn", "not_a_dump"])
def test_damaged_dumps_refused_alike(tmp_path, damage):
    path = tmp_path / "flight-0-1.json"
    doc = pt_flight.seal({"flight": 1, "records": span_stream(2, n=3)})
    text = json.dumps(doc)
    if damage == "tamper":
        doc["payload"]["records"][0]["ts"] += 1.0
        text = json.dumps(doc)
    elif damage == "torn":
        text = text[: len(text) // 2]
    else:
        text = json.dumps({"records": []})
    path.write_text(text)
    errors = []
    for mod in (pt_flight, jax_flight):
        with pytest.raises(ValueError) as exc:
            mod.verify_dump(path)
        errors.append(str(exc.value))
    if damage != "torn":  # json's own message names the offset alike
        assert errors[0] == errors[1]


# --------------------------------------------------------- the recorder


EDGES = [
    {"ev": "step", "ts": 0.5},
    {"ev": "stall_escalation", "ts": 1.0, "stalled_s": 99.0},
    {"ev": "anomaly_rollback", "ts": 2.0, "step": 7},
    {"ev": "chaos", "ts": 5.0, "kind": "fail", "site": "x"},
    {"ev": "chaos", "ts": 6.0, "kind": "kill", "site": "serve/decode"},
]


@pytest.mark.parametrize("ring", [2, 1024])
def test_auto_dump_edges_match(tmp_path, ring):
    got = {}
    for name, mod in PACKAGES.items():
        rec = mod.FlightRecorder(tmp_path / name, ring=ring,
                                 clock=lambda: 7.0, host=0)
        for r in EDGES:
            rec.tap(dict(r))
        # an SLO burning edge from each package's watch machinery
        slo = pt_slo if name == "port" else jax_slo
        watch = slo.SloWatch(cfg=None, emit=rec.tap)
        watch.observe([slo.SloResult("ttft", "latency", slo.STATE_BURNING,
                                     3.0, 3.0, 1.0)], now=8.0)
        watch.observe([slo.SloResult("avail", "availability",
                                     slo.STATE_WARN, 1.5, 0.5, 0.9)],
                      now=9.0)
        dumps = mod.find_dumps(tmp_path / name)
        got[name] = [(p.name, {k: v for k, v in mod.verify_dump(p).items()
                               if k not in ("stacks", "memory_stats")})
                     for p in dumps]
    assert got["port"] == got["jax"]
    assert sorted(p["reason"] for _, p in got["port"]) == [
        "anomaly_rollback", "chaos_kill", "slo_burning",
        "stall_escalation"]


def test_armed_recorder_sees_every_emit(tmp_path):
    rec = pt_flight.arm(tmp_path, metrics_fn=lambda: {"x": 1.0})
    tel = pt_telemetry.get_telemetry()
    for r in span_stream(3, n=4):
        tel.emit(dict(r))
    tel.emit({"ev": "anomaly_rollback", "ts": 2.0, "step": 1})
    (path,) = pt_flight.find_dumps(tmp_path)
    payload = jax_flight.verify_dump(path)
    assert payload["reason"] == "anomaly_rollback"
    assert payload["metrics"] == {"x": 1.0}
    assert payload["records"][0]["ev"] == "flight"  # the armed record
    assert len(payload["records"]) == 2 + len(span_stream(3, n=4))
    assert rec.dump_count == 1
    pt_flight.disarm()
    assert pt_flight.dump_now("killed") is None


def test_excepthook_dumps_then_chains(tmp_path):
    calls = []
    old_hook = sys.excepthook
    sys.excepthook = lambda *a: calls.append(a)
    try:
        pt_flight.arm(tmp_path)
        err = ValueError("boom")
        sys.excepthook(ValueError, err, None)
        (path,) = pt_flight.find_dumps(tmp_path)
        assert jax_flight.verify_dump(path)["reason"] == \
            "unhandled_exception"
        assert calls and calls[0][1] is err
    finally:
        pt_flight.disarm()
        sys.excepthook = old_hook


_DUMP_KILL_SCRIPT = textwrap.dedent("""
    import sys

    from progen_tpu_torch.resilience.chaos import install_from_env
    install_from_env()
    from progen_tpu_torch import telemetry
    from progen_tpu_torch.telemetry import flight

    flight.arm(sys.argv[1])
    tel = telemetry.get_telemetry()
    for i in range(5):
        tel.emit({"ev": "step", "ts": float(i), "i": i})
    for n in range(int(sys.argv[2])):
        flight.dump_now("test%d" % n)
    print("survived")  # unreachable when the kill rule fires
""")


@pytest.mark.parametrize("chaos,n_dumps,left", [
    ("flight/dump:kill@1", 1, []), ("flight/dump:kill@2", 2, ["test0"])])
def test_kill_at_the_dump_site(tmp_path, chaos, n_dumps, left):
    """SIGKILL at the flight/dump span's entry: no torn file and no
    .tmp; the injector's own chaos emit re-enters the tap mid-dump and
    must skip, not deadlock (a hang here is that bug)."""
    env = dict(os.environ, PROGEN_CHAOS=chaos, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _DUMP_KILL_SCRIPT,
                        str(tmp_path), str(n_dumps)], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == -9, (r.stdout, r.stderr)
    dumps = pt_flight.find_dumps(tmp_path)
    assert [jax_flight.verify_dump(p)["reason"] for p in dumps] == left
    assert list(tmp_path.glob("*.tmp")) == []


# ------------------------------------------------------ the profile pin


class FakeProfiler:
    def __init__(self, fail_start=False):
        self.fail_start = fail_start
        self.calls = []

    def start_trace(self, d):
        if self.fail_start:
            raise RuntimeError("no backend")
        self.calls.append(("start", Path(d).name))

    def stop_trace(self):
        self.calls.append(("stop",))


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ack(pin):
    ack = json.loads(Path(str(pin) + ".ack").read_text())
    ack.pop("ts")
    return ack


# each step: ("pin", token, seconds) writes the pin; ("tick", dt) moves
# the clock and polls; ("close",) closes the watcher
PIN_CASES = {
    "start_stop": dict(kw=dict(max_window_s=5.0), steps=[
        ("pin", "a", 2.0), ("tick", 3.0), ("tick", 1.0), ("tick", 1.5),
        ("tick", 10.0)]),
    "rate_limited": dict(kw=dict(max_window_s=1.0, min_interval_s=300.0),
                         steps=[("pin", "first", 1.0), ("tick", 3.0),
                                ("tick", 2.0), ("pin", "second", 1.0),
                                ("tick", 3.0), ("tick", 3.0)]),
    "unavailable": dict(kw={}, fail=True, steps=[("pin", "p1", None),
                                                 ("tick", 3.0)]),
    "clamped": dict(kw=dict(max_window_s=2.0), steps=[
        ("pin", "big", 9999.0), ("tick", 3.0), ("tick", 2.1)]),
    "close_flushes": dict(kw={}, steps=[("pin", "p1", None), ("tick", 3.0),
                                        ("close",)]),
}


@pytest.mark.parametrize("case", sorted(PIN_CASES))
def test_pin_watchers_match(tmp_path, case):
    spec = PIN_CASES[case]
    trail = {}
    for name, mod in PACKAGES.items():
        pin, clock = tmp_path / name / "profile.pin", Clock()
        prof = FakeProfiler(fail_start=spec.get("fail", False))
        w = mod.ProfilePinWatcher(pin, tmp_path / name / "profiles",
                                  clock=clock, profiler=prof, **spec["kw"])
        out = []
        for step in spec["steps"]:
            if step[0] == "pin":
                mod.request_profile(pin, duration_s=step[2], token=step[1])
            elif step[0] == "tick":
                clock.t += step[1]
                out.append((w.poll_watch(), w.active, _ack(pin)
                            if Path(str(pin) + ".ack").exists() else None))
            else:
                w.close()
                out.append((w.active, _ack(pin)))
        trail[name] = (out, prof.calls, w.window_count)
    assert trail["port"] == trail["jax"]


def test_torch_profiler_window_on_the_cpu(tmp_path):
    """The real profiler: a window over a few CPU matmuls writes one
    Chrome trace naming them, and acks started, then stopped."""
    pin, clock = tmp_path / "profile.pin", Clock()
    w = pt_flight.ProfilePinWatcher(
        pin, tmp_path / "profiles", clock=clock,
        profiler=pt_flight.TorchProfiler(cuda=False))
    token = pt_flight.request_profile(pin, duration_s=1.0)
    clock.t += 3.0
    assert w.poll_watch() is True
    assert _ack(pin) == {"pin": token, "status": "started"}
    x = torch.randn(64, 64)
    for _ in range(3):
        x = x @ x / 64
    clock.t += 1.5
    w.poll_watch()
    assert not w.active
    assert _ack(pin) == {"pin": token, "status": "stopped"}
    (trace,) = (tmp_path / "profiles" / f"profile-{token}").glob(
        "*.pt.trace.json")
    doc = json.loads(trace.read_text())
    assert any("mm" in str(e.get("name", "")) for e in doc["traceEvents"])
    assert w._profiler.last_export_s > 0


def test_a_second_window_cannot_nest():
    prof = pt_flight.TorchProfiler(cuda=False)
    with pytest.raises(RuntimeError):
        prof.stop_trace()


# ------------------------------------------------------- trace_timeline


def test_trace_timelines_match(tmp_path):
    tid = "trace-7"
    events = write_jsonl(tmp_path / "events.jsonl", [
        {"ev": "route", "ts": 10.0, "status": "dispatched",
         "trace_id": tid, "req": "r1", "replica": "r0"},
        {"ev": "req", "ts": 10.1, "req": "r1", "ph": "b", "name": "decode"},
        {"ev": "req", "ts": 10.2, "req": "OTHER", "ph": "b",
         "name": "decode"},
        {"ev": "B", "ts": 10.3, "span": "serve/decode", "trace_id": tid}])
    rec = pt_flight.FlightRecorder(tmp_path / "fl", clock=lambda: 12.0,
                                   host=0)
    rec.tap({"ev": "req", "ts": 11.0, "req": "r1", "ph": "n",
             "name": "first_token", "trace_id": tid})
    dump = rec.dump("chaos_kill")
    journal = write_jsonl(tmp_path / "journal.jsonl", [
        {"ev": "journal", "op": "accept", "ts": 9.9, "req": "r1",
         "trace_id": tid}] + [
        {"ev": "journal", "op": "token", "ts": 10.5 + i, "req": "r1",
         "index": i} for i in range(3)] + [
        {"ev": "journal", "op": "done", "ts": 13.0, "req": "r1",
         "status": "ok"}])
    sink = AlertSink(tmp_path / "alerts.jsonl")
    sink.slo_transition({"objective": "ttft_p95", "state": "burning",
                         "ts": 14.0},
                        exemplars={"ttft_s": [{"trace_id": tid,
                                               "value": 3.0}]})
    sink.close()
    notes = sink.path
    kw = dict(events=[events, dump], journals=[journal],
              extra_jsonl=[notes])
    got = pt_flight.trace_timeline(tid, **kw)
    assert got == jax_flight.trace_timeline(tid, **kw)
    assert [e["ts"] for e in got] == sorted(e["ts"] for e in got)
    assert {e["src"] for e in got} == {"events.jsonl", dump.name,
                                       "journal.jsonl", "alerts.jsonl"}
    assert pt_flight.trace_timeline("never", **kw) == []


# ------------------------------------- the killed replica's black box


def test_sigkilled_serve_leaves_queryable_black_box(tmp_path):
    """The port's cli.serve, SIGKILLed by chaos at its 6th decode step,
    leaves a digest-valid flight dump (verified by the JAX package)
    whose ring, joined with the journal, reconstructs the killed
    request's journey, in both packages alike."""
    cfg = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2,
                       window_size=8, global_mlp_depth=1, heads=2,
                       dim_head=16, ff_mult=2, dtype="float32")
    state = init_train_state(cfg, device="cpu", seed=0)
    get_checkpoint_fns(str(tmp_path / "ck"))[2](Package(
        next_seq_index=0, state=state, model_config=cfg.to_dict(),
        run_id="flight"))
    jd, fd = tmp_path / "jd", tmp_path / "flight"
    env = dict(os.environ, PROGEN_CHAOS="serve/decode:kill@6",
               PYTHONPATH=str(REPO))
    reqs = [json.dumps({"id": f"r{i}", "prime": "MKV", "length": 16,
                        "seed": 70 + i, "trace_id": f"tr-{i}"})
            for i in range(3)]
    res = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         "cpu", "--checkpoint_path", str(tmp_path / "ck"), "--max-slots",
         "2", "--max-queue", "16", "--max-len", "24", "--journal_dir",
         str(jd), "--flight_dir", str(fd)],
        input="\n".join(reqs) + "\n", capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=240)
    assert res.returncode == -9, (res.stdout[-500:], res.stderr[-2000:])
    dumps = jax_flight.find_dumps(fd)
    assert dumps, res.stderr[-2000:]
    payload = jax_flight.verify_dump(dumps[-1])
    assert payload["reason"] == "chaos_kill"
    assert pt_flight.verify_dump(dumps[-1]) == payload
    traced = {r.get("trace_id") for r in payload["records"]
              if r.get("trace_id")} & {"tr-0", "tr-1", "tr-2"}
    assert traced
    tid = sorted(traced)[0]
    kw = dict(events=list(dumps), journals=[jd / "journal.jsonl"])
    tl = pt_flight.trace_timeline(tid, **kw)
    assert tl == jax_flight.trace_timeline(tid, **kw)
    whats = [e["what"] for e in tl]
    assert "journal accept" in whats
    assert any(w.startswith("req ") for w in whats)
    assert [e["ts"] for e in tl] == sorted(e["ts"] for e in tl)


# --------------------------------------- cli.train's forensics flags


def test_train_cli_leaves_a_black_box_a_window_and_beacons(tmp_path,
                                                           monkeypatch):
    """``cli.train --flight_dir --profile_pin`` under
    ``train/loss:nan@3``: the rollback leaves a sealed
    ``anomaly_rollback`` dump (verified by the JAX package), a pin
    written before the run opens a window on the live loop (acked
    started, then stopped, its Chrome trace naming ``train/step``), and
    every step taken emits one ``clock_beacon``."""
    from progen_tpu_torch.cli import train as ttrain
    from torch_workspace import make_workspace

    ws = make_workspace(tmp_path / "ws")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    pin = tmp_path / "pin" / "profile.pin"
    token = pt_flight.request_profile(pin, duration_s=0.1)
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("PROGEN_CHAOS", "train/loss:nan@3")
    res = ttrain.run([
        "--device", "cpu", "--seq_len", "32", "--batch_size", "4",
        "--grad_accum_every", "2", "--validate_every", "1000",
        "--sample_every", "1000", "--checkpoint_every", "2",
        "--anomaly_patience", "3", "--num_steps", "6",
        "--config_path", str(ws / "configs" / "model"),
        "--data_path", str(ws / "train_data"),
        "--checkpoint_path", str(tmp_path / "ck"),
        "--flight_dir", str(tmp_path / "flight"),
        "--profile_pin", str(pin)])
    assert len(res["rollbacks"]) == 1
    (dump,) = jax_flight.find_dumps(tmp_path / "flight")
    payload = jax_flight.verify_dump(dump)
    assert payload["reason"] == "anomaly_rollback"
    assert any(r.get("ev") == "clock_beacon" for r in payload["records"])
    assert _ack(pin) == {"pin": token, "status": "stopped"}
    (trace,) = (pin.parent / "profiles" / f"profile-{token}").glob(
        "*.pt.trace.json")
    assert "train/step" in trace.read_text()
    (run,) = (cwd / "runs" / "progen-training").iterdir()
    events = [json.loads(ln) for ln in
              (run / "events.jsonl").read_text().splitlines()]
    beacons = [e["step"] for e in events if e.get("ev") == "clock_beacon"]
    # one a step, the rolled-back step's included
    assert beacons == list(range(1, 7))
    assert set(beacons) >= {s["step"] for s in res["steps"]}
    acks = [e["op"] for e in events if e.get("ev") == "profile"]
    assert acks == ["started", "stopped"]
