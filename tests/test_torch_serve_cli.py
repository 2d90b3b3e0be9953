"""The port's ``cli.serve`` on the CPU, on a tiny checkpoint saved by the
port's ``checkpoint.py`` (vocab 256, dim 32, seq_len 32, depth 2, window
8, one gMLP layer, float32, seeded random weights): the JSON-lines
protocol end to end in a subprocess (token, done, embedding and rejected
lines, an infill template, EOF drains and exits 0), a run SIGKILLed
mid-stream with ``--journal_dir`` followed by a ``--replay`` run (every
accepted id settled exactly once, the streams those of ``sample_fast``),
the resume wire's fields, the fleet and forensics flags accepted, and
the release control line over --socket."""

import json
import re
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.cli import serve
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.training.step import init_train_state
from progen_tpu_torch.workloads.infill import (
    infill_request_arrays,
    parse_template,
)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
REQUESTS = [
    {"id": "r1", "prime": "MKV", "length": 24, "seed": 3},
    {"id": "r2", "prime": "MSKG", "length": 28, "temperature": 0.8,
     "top_p": 0.95, "seed": 4},
    {"id": "t1", "template": "MK?LVG?A??", "seed": 5},
    {"id": "r3", "prime": "GIV", "length": 30, "top_k": 5},
]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint directory and the model restored from it."""
    root = tmp_path_factory.mktemp("torch_serve")
    cfg = ProGenConfig(**TINY)
    state = init_train_state(cfg, device="cpu", seed=1)
    with torch.no_grad():  # an SGU mix that matters at this size
        w = state.model.ff[1].sgu.spatial_weights
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(1)) / 6)
    get_checkpoint_fns(str(root / "ck"))[2](Package(
        next_seq_index=0, state=state, model_config=cfg.to_dict(),
        run_id=None))
    model, _ = load_model(str(root / "ck"), torch.device("cpu"))
    return root / "ck", model


def _serve(ckpt_dir, cwd, lines, *flags, child=None, timeout=120):
    """Run the CLI (or the self-killing child) with ``lines`` on stdin,
    then EOF; (returncode, parsed stdout lines, stderr)."""
    cmd = ([sys.executable, str(REPO / "tests" / "torch_serve_child.py"),
            str(child)] if child else
           [sys.executable, "-m", "progen_tpu_torch.cli.serve"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        cmd + ["--device", "cpu", "--checkpoint_path", str(ckpt_dir),
               "--max-len", "32", *flags],
        input="".join(ln + "\n" for ln in lines), capture_output=True,
        text=True, cwd=cwd, env=env, timeout=timeout)
    return res.returncode, [json.loads(ln) for ln in
                            res.stdout.splitlines()], res.stderr


def _expected(model, req: dict) -> np.ndarray:
    """The request's stream from ``sample_fast`` with the CLI's defaults
    (top_k 25, BOS, seed 42, length = --max-len)."""
    kw = dict(top_k=req.get("top_k", 25), add_bos=True,
              temperature=req.get("temperature", 1.0),
              top_p=req.get("top_p"), device="cpu")
    if "template" in req:
        toks, frz = parse_template(req["template"])
        prime, length, tpl, frozen = infill_request_arrays(toks, frz)
        kw.update(template=tpl, frozen=frozen)
    else:
        prime, length = encode_tokens(req["prime"]), req.get("length", 32)
    return sample_fast(req.get("seed", 42), model, prime, length,
                       **kw).numpy()


def _streams(events) -> dict:
    """id -> {index: token} from token lines."""
    out = {}
    for ev in events:
        if ev["event"] == "token":
            out.setdefault(ev["id"], {})[ev["index"]] = ev["token"]
    return out


def _check_stream(model, req, got: dict) -> None:
    want = _expected(model, req)
    assert got and sorted(got) == list(range(min(got), max(got) + 1))
    np.testing.assert_array_equal([got[i] for i in sorted(got)],
                                  want[min(got):max(got) + 1])
    tail = want[max(got) + 1:]
    assert (tail == 0).all()  # the stream stopped where sample_fast's did


def test_protocol_end_to_end(ckpt, tmp_path):
    ck, model = ckpt
    lines = [json.dumps(r) for r in REQUESTS] + [
        json.dumps({"id": "e1", "prime": "MKTAYI", "embed": True}),
        json.dumps({"id": "long", "prime": "MK", "length": 99}),
        "not json",
        json.dumps({"id": "knob", "prime": "MK", "temperature": 0}),
    ]
    rc, events, err = _serve(ck, tmp_path, lines, "--max-slots", "2",
                             "--prefill_chunk", "2")
    assert rc == 0, err
    streams = _streams(events)
    for req in REQUESTS:
        _check_stream(model, req, streams[req["id"]])
    done = {ev["id"]: ev for ev in events if ev["event"] == "done"}
    assert sorted(done) == ["r1", "r2", "r3", "t1"]
    frozen = [i + 1 for i, c in enumerate(REQUESTS[2]["template"])
              if c != "?"]
    t1 = _expected(model, REQUESTS[2])
    assert all(t1[i] == ord(REQUESTS[2]["template"][i - 1]) + 1
               for i in frozen)
    (emb,) = [ev for ev in events if ev["event"] == "embedding"]
    assert emb["id"] == "e1" and emb["dim"] == 32 == len(emb["values"])
    rejected = {ev["id"]: ev["reason"] for ev in events
                if ev["event"] == "rejected"}
    assert rejected["long"].startswith("invalid: length 99")
    assert rejected[None].startswith("bad request line")
    assert rejected["knob"].startswith("invalid: temperature")
    assert "request traces: runs/progen-serve/" in err
    trace = next((tmp_path / "runs" / "progen-serve").glob(
        "*/events.jsonl")).read_text().splitlines()
    assert any('"serve/embed"' in ln for ln in trace)


def test_journal_kill_then_replay_settles_each_id_once(ckpt, tmp_path):
    ck, model = ckpt
    jd = str(tmp_path / "journal")
    lines = [json.dumps(r) for r in REQUESTS]
    rc, first, err = _serve(ck, tmp_path, lines, "--max-slots", "2",
                            "--journal_dir", jd, child=6)
    assert rc == -9, err
    assert _streams(first), "the first life emitted no token"
    rc, second, err = _serve(ck, tmp_path, [], "--max-slots", "2",
                             "--journal_dir", jd, "--replay", jd)
    assert rc == 0, err
    assert "replay: resumed" in err
    settled = [ev["id"] for ev in first + second if ev["event"] == "done"]
    assert sorted(settled) == sorted(r["id"] for r in REQUESTS)
    # the journal holds each stream over both lives, the uninterrupted one
    toks = {}
    for line in Path(jd, "journal.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["op"] == "token":
            toks.setdefault(rec["req"], {})[rec["index"]] = rec["token"]
    for req in REQUESTS:
        _check_stream(model, req, toks[req["id"]])
    # a third life has nothing left to do
    rc, third, err = _serve(ck, tmp_path, [], "--journal_dir", jd,
                            "--replay", jd)
    assert rc == 0 and third == [], err


def test_parse_request_takes_the_resume_wire():
    defaults = {"length": 32, "top_k": 25, "temperature": 1.0,
                "top_p": None, "seed": 42}
    req, err = serve.parse_request(json.dumps({
        "id": "x", "prime_tokens": [0, 5, 6], "add_bos": False,
        "draw_offset": 7, "seed": 9, "length": 20,
        "template_tokens": [0] * 19 + [4], "frozen": [False] * 19 + [True],
        "trace_id": "t-1", "deadline_s": 2}), defaults)
    assert err is None
    assert (req.prime.tolist(), req.add_bos, req.draw_offset, req.seed,
            req.length, req.trace_id, req.deadline_s) == (
        [0, 5, 6], False, 7, 9, 20, "t-1", 2.0)
    assert req.template[-1] == 4 and req.frozen[-1] and not req.frozen[0]
    req, err = serve.parse_request('{"id": "y", "prime": "MK"}', defaults)
    assert (req.prime.tolist(), req.add_bos, req.draw_offset, req.top_k,
            req.seed, req.length) == ([78, 76], True, 0, 25, 42, 32)
    req, err = serve.parse_request('{"id": "z", "top_k": "x"}', defaults)
    assert req.id == "z" and err.startswith("bad request fields")


@pytest.mark.parametrize("argv,attr,want", [
    (["--socket", "/tmp/s.sock"], "socket_path", "/tmp/s.sock"),
    (["--tcp", "127.0.0.1:0"], "tcp_hostport", "127.0.0.1:0"),
    (["--idle_timeout", "3"], "idle_timeout", 3.0),
    (["--reload_watch", "2.5"], "reload_watch", 2.5),
    (["--reload_pin", "/tmp/reload.pin"], "reload_pin_path",
     "/tmp/reload.pin"),
])
def test_accepts_the_fleet_flags(argv, attr, want):
    assert getattr(serve.parse_args(argv), attr) == want


@pytest.mark.parametrize("argv,attr,want", [
    (["--flight_dir", "/tmp/f"], "flight_dir", "/tmp/f"),
    (["--profile_pin", "/tmp/p.pin"], "profile_pin_path", "/tmp/p.pin"),
    (["--profile_out", "/tmp/prof"], "profile_out", "/tmp/prof"),
])
def test_accepts_the_forensics_flags(argv, attr, want):
    assert getattr(serve.parse_args(argv), attr) == want


def test_runs_on_the_card_unless_asked(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(["--checkpoint_path", str(ckpt[0])])


def test_prom_file_carries_the_metrics_and_exemplars(ckpt, tmp_path):
    """--prom_file: the scheduler's metrics as Prometheus text under
    progen_serve_, the latency reservoirs with the requests' trace ids
    as exemplars, rewritten every --metrics-every steps and at exit."""
    ck, _ = ckpt
    prom = tmp_path / "serve.prom"
    lines = [json.dumps({**REQUESTS[0], "trace_id": "tr-a"}),
             json.dumps({**REQUESTS[3], "trace_id": "tr-b"})]
    rc, events, err = _serve(ck, tmp_path, lines, "--prom_file", str(prom),
                             "--metrics-every", "4", "--heartbeat", "0.05")
    assert rc == 0, err
    text = prom.read_text()
    assert "progen_serve_requests_completed_total 2" in text
    assert "# TYPE progen_serve_ttft_seconds summary" in text
    assert "progen_serve_latency_seconds_count 2" in text
    assert re.search(r'^progen_serve_latency_seconds\{quantile="0\.99"\} '
                     r'\S+ # \{trace_id="tr-[ab]"\} \S+$', text, re.M)
    assert "progen_serve_decode_tokens_per_s" in text


def test_prom_file_carries_the_kernel_launches(ckpt, tmp_path):
    """--prom_file also carries the process's own kernel launches, one
    gauge per kernel id; on the CPU every wrapper takes its plain
    version, which counts none, so an embedding leaves them all 0."""
    from progen_tpu_torch.ops.launches import WRAPPERS, gauge_name

    ck, _ = ckpt
    prom = tmp_path / "serve.prom"
    line = json.dumps({"id": "e", "prime": "MKTAYIAKQR", "embed": True})
    rc, events, err = _serve(ck, tmp_path, [line], "--prom_file", str(prom))
    assert rc == 0, err
    assert [e["event"] for e in events] == ["embedding"]
    text = prom.read_text()
    for rid in WRAPPERS:
        assert f"progen_serve_{gauge_name(rid)} 0\n" in text


def test_socket_release_control_line(ckpt, tmp_path):
    """--socket: a client's own events only, and ``{"ctl": "release"}``
    gives back a still-queued request (journaled ``handed_off``, so a
    replay skips it) but not one on a slot."""
    import select
    import signal
    import socket
    import time

    from progen_tpu_torch.fleet.transport import LineConnection

    ck, model = ckpt
    sock, jd = tmp_path / "s.sock", tmp_path / "jd"
    proc = subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         "cpu", "--checkpoint_path", str(ck), "--max-len", "32",
         "--max-slots", "1", "--socket", str(sock), "--journal_dir",
         str(jd)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)))
    events = []
    try:
        deadline = time.monotonic() + 120
        while not sock.exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(str(sock))
        conn = LineConnection(s)
        for req in REQUESTS[:2]:
            conn.send_line(json.dumps(req))

        def read_until(pred):
            while not pred():
                assert time.monotonic() < deadline, events
                if select.select([conn], [], [], 0.1)[0]:
                    lines, eof = conn.recv_lines()
                    events.extend(json.loads(ln) for ln in lines)
                    assert not eof

        read_until(lambda: any(e["event"] == "token" for e in events))
        for rid in ("r2", "r1"):
            conn.send_line(json.dumps({"ctl": "release", "id": rid}))
        read_until(lambda: sum(e["event"] == "released" for e in events) == 2
                   and any(e["event"] == "done" for e in events))
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    released = {e["id"]: e["released"] for e in events
                if e["event"] == "released"}
    assert released == {"r2": True, "r1": False}
    assert [e["id"] for e in events if e["event"] == "done"] == ["r1"]
    assert {e["id"] for e in events if e["event"] == "token"} == {"r1"}
    _check_stream(model, REQUESTS[0], _streams(events)["r1"])
    marks = [json.loads(ln) for ln in (jd / "journal.jsonl").read_text()
             .splitlines() if '"done"' in ln]
    assert sorted((m["req"].split(":", 1)[1], m["status"],
                   m.get("resumed_by")) for m in marks) == [
        ("r1", "completed", None), ("r2", "handed_off", "router")]


def test_prom_file_carries_the_checkpoint_digest(ckpt, tmp_path):
    """--prom_file carries the served checkpoint's identity as
    progen_serve_checkpoint_digest (digest_gauge of checkpoint_digest),
    and a committed pinned reload moves it to the new checkpoint's at
    once, without waiting for a metrics cadence."""
    import shutil
    import time

    from progen_tpu_torch.checkpoint import checkpoint_digest, digest_gauge
    from progen_tpu_torch.training.optimizer import (
        MaskedAdamW,
        OptimizerConfig,
    )
    from progen_tpu_torch.training.state import TrainState

    src, model = ckpt
    ck = tmp_path / "ck"
    shutil.copytree(src, ck)
    (name_a,) = [p.name for p in ck.iterdir()]
    prom, pin = tmp_path / "serve.prom", tmp_path / "reload.pin"

    def gauge():
        m = re.search(r"^progen_serve_checkpoint_digest (\S+)$",
                      prom.read_text() if prom.exists() else "", re.M)
        return None if m is None else float(m.group(1))

    def wait(pred, what):
        deadline = time.monotonic() + 120
        while not pred():
            assert proc.poll() is None, err.read_text()[-2000:]
            assert time.monotonic() < deadline, what
            time.sleep(0.05)

    err = tmp_path / "stderr.log"
    proc = subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         "cpu", "--checkpoint_path", str(ck), "--max-len", "32",
         "--prom_file", str(prom), "--heartbeat", "0.05",
         "--reload_watch", "0.2", "--reload_pin", str(pin)],
        stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
        stderr=open(err, "w"), cwd=tmp_path, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        want_a = digest_gauge(checkpoint_digest(ck / name_a))
        wait(lambda: gauge() is not None, "the first exposition")
        assert gauge() == want_a and want_a > 0
        model_b = load_model(str(ck), torch.device("cpu"))[0]
        with torch.no_grad():
            for p in model_b.parameters():
                p.mul_(1.25)
        name_b = Path(get_checkpoint_fns(str(ck))[2](Package(
            next_seq_index=0, state=TrainState(1, model_b, MaskedAdamW(
                model_b, OptimizerConfig())),
            model_config=model_b.config.to_dict(), run_id="b"))).name
        want_b = digest_gauge(checkpoint_digest(ck / name_b))
        assert want_b not in (want_a, -1.0)
        tmp = pin.with_name(pin.name + ".tmp")
        with tmp.open("w") as f:  # the controller's atomic pin write
            f.write(name_b + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, pin)
        ack = pin.with_name(pin.name + ".ack")
        wait(lambda: ack.exists() and json.loads(ack.read_text()).get(
            "status") == "committed", "the pin's ack")
        assert json.loads(ack.read_text())["pin"] == name_b
        wait(lambda: gauge() == want_b, "the gauge on the new checkpoint")
        proc.stdin.close()  # EOF drains
        assert proc.wait(timeout=60) == 0, err.read_text()[-2000:]
        assert gauge() == want_b
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
