"""The fleet kill matrix against the port's CLIs on the CPU: the
scenarios of ``tests/test_serve_kill_matrix.py`` and
``tests/test_router_kill_matrix.py`` run with real ``python -m
progen_tpu_torch.cli.serve --device cpu`` replicas and
``progen_tpu_torch.cli.router`` fronts (a SIGKILL rule in-process would
take pytest down with it), on a checkpoint saved by the port
(vocab 256, dim 32, seq_len 32, depth 2, window 8, one gMLP layer,
float32, seeded weights). The invariants:

  1. every request the fleet accepted settles exactly once across the
     processes' lives: a replica's death mid-stream hands its journaled
     work to a survivor, nothing is lost, nothing answered twice;
  2. no (request, index) token is emitted twice;
  3. every stream equals the uninterrupted ``sample_fast`` stream of
     its original accept (seed, prime, draw offset 0), bit for bit;
  4. a ``--replay`` restart of the dead replica resumes nothing: the
     router's ``handed_off`` marks settle its journal;
  5. a SIGHUP reload under live traffic commits with no request dropped
     or rejected, and a request admitted after the commit is served on
     the new weights.

In tier 1: the SIGHUP reload, the kill mid-decode and mid-chunk of one
``cli.serve`` with a replay, the replica killed mid-decode behind the
router over a unix socket and over framed TCP, and a ``--spawn
--respawn`` fleet. Marked ``slow``, as the JAX matrices mark them: the
prefill kill and the reload kill of one server, the decode-kill sweeps,
and the router's prefill kill, handoff fault and dispatch fault.
"""

import json
import os
import re
import select
import shutil
import signal
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.resilience import chaos
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.serving.journal import (
    STATUS_HANDED_OFF,
    replay_requests,
)
from progen_tpu_torch.telemetry.trace import iter_jsonl
from progen_tpu_torch.training.optimizer import MaskedAdamW, OptimizerConfig
from progen_tpu_torch.training.state import TrainState
from progen_tpu_torch.training.step import init_train_state

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
TOKEN = "fleet-test-token"
# journal ids are namespaced twice on the way down: the replica's
# connection prepends "{n}:", the router's wire ids prepend "q{seq}-"
_NS_RE = re.compile(r"^(?:\d+:)?(?:q\d+-)?")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A checkpoint directory (one checkpoint) and the model restored
    from it, for the references."""
    root = tmp_path_factory.mktemp("torch_fleet")
    cfg = ProGenConfig(**TINY)
    state = init_train_state(cfg, device="cpu", seed=2)
    with torch.no_grad():  # an SGU mix that matters at this size
        w = state.model.ff[1].sgu.spatial_weights
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(2)) / 6)
    get_checkpoint_fns(str(root / "ck"))[2](Package(
        next_seq_index=0, state=state, model_config=cfg.to_dict(),
        run_id=None))
    model, _ = load_model(str(root / "ck"), torch.device("cpu"))
    return {"ck": root / "ck", "model": model, "cfg": cfg}


def _env(chaos_spec="", token=None):
    env = dict(os.environ, PROGEN_CHAOS=chaos_spec,
               PYTHONPATH=f"{REPO}{os.pathsep}"
               + os.environ.get("PYTHONPATH", ""))
    env.pop("PROGEN_FLEET_TOKEN", None)
    if token is not None:
        env["PROGEN_FLEET_TOKEN"] = token
    return env


def _serve_cmd(ck, journal_dir, *extra):
    return [sys.executable, "-m", "progen_tpu_torch.cli.serve",
            "--device", "cpu", "--checkpoint_path", str(ck),
            "--max-slots", "2", "--max-queue", "16", "--max-len", "24",
            "--journal_dir", str(journal_dir), *extra]


def _requests(n, length=16):
    return [json.dumps({"id": f"r{i}", "prime": "MKV", "length": length,
                        "seed": 70 + i}) for i in range(n)]


def _parse_events(lines):
    """Protocol lines -> (tokens [(id, index, token)], done ids,
    rejections). A killed writer may tear its last line: skipped."""
    tokens, done, rejected = [], [], []
    for line in lines:
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if ev.get("event") == "token":
            tokens.append((ev["id"], ev["index"], ev["token"]))
        elif ev.get("event") == "done":
            done.append(ev["id"])
        elif ev.get("event") == "rejected":
            rejected.append(ev)
    return tokens, done, rejected


def _journal_accepts(journal_dir):
    """journal id -> its first accept record."""
    accepts = {}
    path = Path(journal_dir) / "journal.jsonl"
    if path.exists():
        for rec in iter_jsonl(path):
            if rec.get("ev") == "journal" and rec.get("op") == "accept":
                accepts.setdefault(rec["req"], rec)
    return accepts


def _original_accepts(dirs):
    """public id -> the original accept across the journals (a resume's
    accept carries a longer prime and a later draw offset)."""
    out = {}
    for d in dirs:
        for jid, acc in _journal_accepts(d).items():
            pub = _NS_RE.sub("", jid)
            if pub not in out or acc["draw_offset"] < \
                    out[pub]["draw_offset"]:
                out[pub] = acc
    return out


def _assert_parity(model, originals, tokens):
    """Every emitted (id, index, token) equals the uninterrupted
    ``sample_fast`` stream of the original accept."""
    refs = {}
    for pub, acc in originals.items():
        assert acc["draw_offset"] == 0
        refs[pub] = sample_fast(
            acc["seed"], model, np.asarray(acc["prime"]), acc["length"],
            top_k=acc["top_k"], add_bos=acc["add_bos"],
            temperature=acc["temperature"], top_p=acc["top_p"],
            device="cpu").numpy()
    for rid, ix, tok in tokens:
        assert rid in refs, f"a token of unjournaled request {rid}"
        assert refs[rid][ix] == tok, (rid, ix, tok, int(refs[rid][ix]))


def _assert_exactly_once(done, rejected, tokens, ids):
    assert sorted(done) == sorted(ids)
    assert rejected == []
    pairs = [(i, ix) for i, ix, _ in tokens]
    assert len(set(pairs)) == len(pairs)


def _pump(proc, out_lines, err_lines, pred, timeout_s):
    """Drain both pipes into line lists until ``pred()`` or the deadline,
    reading the raw fds (a buffered readline would strand lines)."""
    tails = getattr(proc, "_pump_tails", None)
    if tails is None:
        tails = proc._pump_tails = {
            proc.stdout.fileno(): ["", out_lines, False],
            proc.stderr.fileno(): ["", err_lines, False],
        }
    deadline = time.time() + timeout_s
    while not pred():
        if time.time() > deadline:
            return False
        live = [fd for fd, t in tails.items() if not t[2]]
        if not live:
            return pred()
        r, _, _ = select.select(live, [], [], 0.5)
        for fd in r:
            data = os.read(fd, 65536)
            t = tails[fd]
            if not data:
                t[2] = True
                if t[0]:
                    t[1].append(t[0])
                    t[0] = ""
                continue
            *full, t[0] = (t[0] + data.decode("utf-8", "replace")).split(
                "\n")
            t[1].extend(full)
        if proc.poll() is not None and not r:
            return pred()
    return True


def _drain(proc, out_lines, err_lines, timeout_s=240):
    """Read both pipes to their ends and wait for the exit."""
    assert _pump(proc, out_lines, err_lines,
                 lambda: all(t[2] for t in proc._pump_tails.values()),
                 timeout_s), "\n".join(err_lines)[-2000:]
    proc.wait(timeout=60)


# ----- one cli.serve: kill, replay, reload -------------------------------


def _kill_then_replay(workspace, tmp_path, chaos_spec, requests=None,
                      extra=()):
    """cli.serve under a kill rule, then a chaos-free --replay run with
    the same flags; (tokens1, done1, tokens2, done2, accepts)."""
    jd = tmp_path / "jd"
    reqs = _requests(4) if requests is None else requests
    first = subprocess.run(
        _serve_cmd(workspace["ck"], jd, *extra),
        input="\n".join(reqs) + "\n", capture_output=True, text=True,
        env=_env(chaos_spec), cwd=tmp_path, timeout=240)
    assert first.returncode == -9, first.stderr[-2000:]
    second = subprocess.run(
        _serve_cmd(workspace["ck"], jd, "--replay", str(jd), *extra),
        input="", capture_output=True, text=True, env=_env(),
        cwd=tmp_path, timeout=240)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "replay:" in second.stderr
    tokens1, done1, _ = _parse_events(first.stdout.splitlines())
    tokens2, done2, _ = _parse_events(second.stdout.splitlines())
    accepts = _journal_accepts(jd)
    assert accepts, "the dead process accepted nothing"
    assert sorted(done1 + done2) == sorted(accepts)
    pairs = [(i, ix) for i, ix, _ in tokens1 + tokens2]
    assert len(set(pairs)) == len(pairs)
    return tokens1, done1, tokens2, done2, accepts


class TestServeKills:
    def test_kill_mid_decode_replay_recovers_all(self, workspace,
                                                 tmp_path):
        tokens1, _, tokens2, _, accepts = _kill_then_replay(
            workspace, tmp_path, "serve/decode:kill@6")
        assert tokens1 and tokens2  # the kill landed mid-flight
        _assert_parity(workspace["model"], accepts, tokens1 + tokens2)

    def test_kill_mid_chunk_replay_settles_once(self, workspace,
                                                tmp_path):
        """SIGKILL inside the second prefill chunk: the journal holds no
        partial-prefill state and the replay re-runs the prefill."""
        reqs = [json.dumps({"id": f"c{i}", "prime": "MKVLATGLLSDQ",
                            "length": 20, "seed": 50 + i})
                for i in range(4)]
        _, _, _, done2, _ = _kill_then_replay(
            workspace, tmp_path, "serve/prefill_chunk:kill@2",
            requests=reqs,
            extra=["--prefill_chunk", "4", "--prefix_cache_mb", "8"])
        assert done2, "the replay settled nothing"
        ops = {rec["op"] for rec in iter_jsonl(tmp_path / "jd"
                                               / "journal.jsonl")}
        assert ops <= {"accept", "token", "done"}


class TestSighupReload:
    def test_sighup_reload_under_live_traffic(self, workspace, tmp_path):
        """Serve, save a new checkpoint, SIGHUP, serve more: the reload
        commits ("now serving ckpt_N"), every request of every wave
        completes with no rejection, and a request sent after the commit
        equals sample_fast on the new weights."""
        ck = tmp_path / "ck"
        shutil.copytree(workspace["ck"], ck)
        proc = subprocess.Popen(
            _serve_cmd(ck, tmp_path / "jd"), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            bufsize=1, env=_env(), cwd=tmp_path)
        out, err = [], []
        try:
            proc.stdin.write("\n".join(_requests(2, length=20)) + "\n")
            proc.stdin.flush()
            assert _pump(proc, out, err,
                         lambda: any('"token"' in ln for ln in out), 120)
            model_b = ProGen(workspace["cfg"], device="cpu", seed=None)
            model_b.load_state_dict({k: v * 1.3 for k, v in workspace[
                "model"].state_dict().items()})
            saved = get_checkpoint_fns(str(ck))[2](Package(
                next_seq_index=0, state=TrainState(1, model_b, MaskedAdamW(
                    model_b, OptimizerConfig())),
                model_config=workspace["cfg"].to_dict(), run_id="b"))
            os.kill(proc.pid, signal.SIGHUP)
            proc.stdin.write("\n".join(
                json.dumps({"id": f"w{i}", "prime": "GA", "length": 16,
                            "seed": 90 + i}) for i in range(2)) + "\n")
            proc.stdin.flush()
            committed = f"now serving {Path(saved).name}"
            assert _pump(proc, out, err,
                         lambda: any(committed in ln for ln in err), 120), \
                "\n".join(err)[-2000:]
            after = {"id": "after", "prime": "MKTAY", "length": 22,
                     "seed": 3}
            proc.stdin.write(json.dumps(after) + "\n")
            proc.stdin.close()  # EOF drains
            _drain(proc, out, err)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, "\n".join(err)[-2000:]
        tokens, done, rejected = _parse_events(out)
        assert sorted(done) == ["after", "r0", "r1", "w0", "w1"]
        assert rejected == [] and "rejected" not in "\n".join(err)
        got = {ix: tok for i, ix, tok in tokens if i == "after"}
        want = sample_fast(3, model_b.eval(), encode_tokens("MKTAY"), 22,
                           add_bos=True, device="cpu").numpy()
        n = max(got) + 1
        np.testing.assert_array_equal([got[i] for i in range(6, n)],
                                      want[6:n])


# ----- the router in front of replicas -------------------------------------


def _spawn_replica(ck, rdir, *, chaos_spec="", replay=False, tcp=False,
                   token=None):
    """A cli.serve replica on a unix socket (or framed TCP on an
    ephemeral port) with its journal and exposition in ``rdir``; stderr
    to ``rdir/stderr.log``."""
    rdir = Path(rdir)
    rdir.mkdir(parents=True, exist_ok=True)
    wire = (["--tcp", "127.0.0.1:0"] if tcp
            else ["--socket", str(rdir / "serve.sock")])
    extra = ["--replay", str(rdir)] if replay else []
    return subprocess.Popen(
        _serve_cmd(ck, rdir, *wire, "--prom_file", str(rdir / "m.prom"),
                   "--metrics-every", "2", *extra),
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=open(rdir / "stderr.log", "a"), env=_env(chaos_spec, token),
        cwd=rdir)


def _wait_up(proc, rdir, tcp=False, min_count=1, timeout_s=120):
    """Until the replica listens: its socket file, or (TCP) its
    ``min_count``-th "listening on tcp" line; returns the endpoint."""
    rdir = Path(rdir)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        log = (rdir / "stderr.log").read_text()
        if tcp:
            ports = re.findall(r"listening on tcp (\S+)", log)
            if len(ports) >= min_count:
                return ports[-1]
        elif (rdir / "serve.sock").exists():
            return str(rdir / "serve.sock")
        if proc.poll() is not None:
            pytest.fail(f"a replica died while starting: {log[-2000:]}")
        time.sleep(0.1)
    pytest.fail(f"a replica never listened: {rdir}")


def _route(specs, lines, *, chaos_spec="", token=None, cwd=None):
    """cli.router over ``specs`` with ``lines`` on stdin, then EOF: it
    settles everything and exits. (tokens, done, rejected, stderr)."""
    cmd = [sys.executable, "-m", "progen_tpu_torch.cli.router"]
    for spec in specs:
        cmd += ["--replica", spec]
    res = subprocess.run(cmd, input="\n".join(lines) + "\n",
                         capture_output=True, text=True, timeout=300,
                         env=_env(chaos_spec, token), cwd=cwd)
    assert res.returncode == 0, res.stderr[-2000:]
    return (*_parse_events(res.stdout.splitlines()), res.stderr)


def _spec(rdir, endpoint, tcp=False):
    wire = f"tcp={endpoint}" if tcp else f"sock={endpoint}"
    return f"{wire},journal={rdir},prom={Path(rdir) / 'm.prom'}"


def _terminate(proc):
    """One SIGTERM (a drain): cli.serve takes a second one as "exit
    now"."""
    if proc.poll() is None and not getattr(proc, "_terminated", False):
        proc.terminate()
        proc._terminated = True


def _stop(proc, timeout_s=120):
    """Drain a replica and wait for its exit code."""
    _terminate(proc)
    try:
        return proc.wait(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()


def _run_fleet(workspace, tmp_path, *, victim_chaos="", router_chaos="",
               victim_tcp=False, n_requests=4):
    """Replica 0 (the victim, under ``victim_chaos``, on a unix socket or
    TCP) and replica 1 (a unix socket) behind one router fed
    ``n_requests`` requests and EOF. Returns (tokens, done, rejected,
    dirs, processes)."""
    dirs = [tmp_path / "r0", tmp_path / "r1"]
    token = TOKEN if victim_tcp else None
    procs = [_spawn_replica(workspace["ck"], dirs[0], chaos_spec=victim_chaos,
                            tcp=victim_tcp, token=token),
             _spawn_replica(workspace["ck"], dirs[1])]
    try:
        ends = [_wait_up(procs[0], dirs[0], tcp=victim_tcp),
                _wait_up(procs[1], dirs[1])]
        tokens, done, rejected, _ = _route(
            [_spec(dirs[0], ends[0], victim_tcp), _spec(dirs[1], ends[1])],
            _requests(n_requests), chaos_spec=router_chaos, token=token,
            cwd=tmp_path)
    finally:
        for p in procs:
            _terminate(p)
    return tokens, done, rejected, dirs, procs


def _assert_handed_off(victim_dir):
    """The dead journal is settled by the router's marks: a replay of
    it has nothing left to do."""
    marks = [rec for rec in iter_jsonl(Path(victim_dir) / "journal.jsonl")
             if rec.get("op") == "done"]
    assert any(m["status"] == STATUS_HANDED_OFF for m in marks)
    pending, finished, n_done = replay_requests(
        Path(victim_dir) / "journal.jsonl")
    assert pending == [] and finished == []
    assert n_done == len(_journal_accepts(victim_dir))


class TestFleetKills:
    def test_replica_sigkill_mid_decode_fleet_recovers(self, workspace,
                                                       tmp_path):
        """Replica 0 dies at its 6th decode step with the fleet
        mid-stream over unix sockets: exactly once, no duplicate token,
        every stream sample_fast's, and a --replay rebirth of the victim
        resumes nothing."""
        tokens, done, rejected, dirs, procs = _run_fleet(
            workspace, tmp_path, victim_chaos="serve/decode:kill@6")
        assert procs[0].wait(timeout=60) == -9
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        assert _journal_accepts(dirs[0]), "the kill came before an accept"
        _assert_handed_off(dirs[0])
        originals = _original_accepts(dirs)
        assert sorted(originals) == ["r0", "r1", "r2", "r3"]
        _assert_parity(workspace["model"], originals, tokens)
        assert _stop(procs[1]) == 0
        (dirs[0] / "serve.sock").unlink()  # SIGKILL left the file behind
        reborn = _spawn_replica(workspace["ck"], dirs[0], replay=True)
        _wait_up(reborn, dirs[0])
        assert _stop(reborn) == 0
        log = (dirs[0] / "stderr.log").read_text()
        assert "replay: resumed 0 request(s)" in log, log[-2000:]

    def test_replica_sigkill_mid_tcp_stream_fleet_recovers(self, workspace,
                                                           tmp_path):
        """The TCP twin: the victim serves framed TCP with a fleet token,
        the survivor a unix socket, one router fronts both. The frame's
        payload is the JSONL line, so the same invariants hold."""
        tokens, done, rejected, dirs, procs = _run_fleet(
            workspace, tmp_path, victim_chaos="serve/decode:kill@6",
            victim_tcp=True)
        assert procs[0].wait(timeout=60) == -9
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        assert _journal_accepts(dirs[0]), "the kill came before an accept"
        _assert_handed_off(dirs[0])
        originals = _original_accepts(dirs)
        assert sorted(originals) == ["r0", "r1", "r2", "r3"]
        _assert_parity(workspace["model"], originals, tokens)
        assert _stop(procs[1]) == 0
        reborn = _spawn_replica(workspace["ck"], dirs[0], replay=True,
                                tcp=True, token=TOKEN)
        _wait_up(reborn, dirs[0], tcp=True, min_count=2)
        assert _stop(reborn) == 0
        log = (dirs[0] / "stderr.log").read_text()
        assert "replay: resumed 0 request(s)" in log, log[-2000:]

    def test_spawned_fleet_respawns_a_killed_replica(self, workspace,
                                                     tmp_path):
        """``--spawn 2 --respawn --device cpu``: each replica under
        FLEET_DIR/replica{i}/; a SIGKILLed one comes back with --replay
        of its own journal, and the fleet still answers."""
        fleet = tmp_path / "fleet"
        router = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.router",
             "--spawn", "2", "--respawn", "--device", "cpu",
             "--checkpoint_path", str(workspace["ck"]),
             "--fleet_dir", str(fleet), "--max-len", "24",
             "--replica-max-slots", "2"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1, env=_env(),
            cwd=tmp_path)
        out, err = [], []
        try:
            assert _pump(router, out, err, lambda: all(
                (fleet / f"replica{i}" / "serve.sock").exists()
                for i in range(2)), 120), "\n".join(err)[-2000:]
            pid = int(re.search(r"replica0: pid (\d+)",
                                "\n".join(err)).group(1))
            os.kill(pid, signal.SIGKILL)
            log = fleet / "replica0" / "replica.log"
            assert _pump(router, out, err, lambda: "replay: resumed" in
                         log.read_text(), 120), "\n".join(err)[-2000:]
            router.stdin.write("\n".join(_requests(2)) + "\n")
            router.stdin.close()
            _drain(router, out, err)
        finally:
            if router.poll() is None:
                router.kill()
                router.wait()
        assert router.returncode == 0, "\n".join(err)[-2000:]
        assert "replica0: exited rc=-9" in "\n".join(err)
        assert "(replaying its journal)" in "\n".join(err)
        for i in range(2):
            for name in ("journal.jsonl", "metrics.prom", "replica.log"):
                assert (fleet / f"replica{i}" / name).exists()
        tokens, done, rejected = _parse_events(out)
        _assert_exactly_once(done, rejected, tokens, ["r0", "r1"])


@pytest.mark.slow
class TestServeKillsSlow:
    def test_kill_mid_prefill_replay_recovers_all(self, workspace,
                                                  tmp_path):
        _, _, _, done2, _ = _kill_then_replay(workspace, tmp_path,
                                              "serve/prefill:kill@2")
        assert done2, "the replay settled nothing"

    def test_kill_mid_reload_never_torn(self, workspace, tmp_path):
        """SIGKILL inside the reload's background load: a restart replays
        every accepted request and serves from the intact checkpoint."""
        jd = tmp_path / "jd"
        proc = subprocess.Popen(
            _serve_cmd(workspace["ck"], jd), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env("serve/reload:kill@1"), cwd=tmp_path)
        proc.stdin.write("\n".join(_requests(4, length=24)) + "\n")
        proc.stdin.flush()
        deadline = time.time() + 120
        while len(_journal_accepts(jd)) < 4 and time.time() < deadline:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            time.sleep(0.1)
        assert len(_journal_accepts(jd)) == 4
        os.kill(proc.pid, signal.SIGHUP)
        out1, err1 = proc.communicate(timeout=120)
        assert proc.returncode == -9, err1[-2000:]
        second = subprocess.run(
            _serve_cmd(workspace["ck"], jd, "--replay", str(jd)), input="",
            capture_output=True, text=True, env=_env(), cwd=tmp_path,
            timeout=240)
        assert second.returncode == 0, second.stderr[-2000:]
        _, done1, _ = _parse_events(out1.splitlines())
        _, done2, _ = _parse_events(second.stdout.splitlines())
        assert sorted(done1 + done2) == sorted(_journal_accepts(jd))

    @pytest.mark.parametrize("n", [3, 9, 14])
    def test_randomized_decode_kill_bit_parity(self, workspace, tmp_path,
                                               n):
        tokens1, _, tokens2, _, accepts = _kill_then_replay(
            workspace, tmp_path, f"serve/decode:kill@{n}")
        _assert_parity(workspace["model"], accepts, tokens1 + tokens2)


@pytest.mark.slow
class TestFleetKillsSlow:
    def test_replica_sigkill_mid_prefill(self, workspace, tmp_path):
        tokens, done, rejected, dirs, procs = _run_fleet(
            workspace, tmp_path, victim_chaos="serve/prefill:kill@2")
        assert procs[0].wait(timeout=60) == -9
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        _assert_parity(workspace["model"], _original_accepts(dirs), tokens)

    def test_handoff_site_fault_does_not_lose_work(self, workspace,
                                                   tmp_path):
        """A transient fault at the router's handoff span is retried (the
        fold is idempotent): the kill still loses nothing."""
        tokens, done, rejected, dirs, procs = _run_fleet(
            workspace, tmp_path, victim_chaos="serve/decode:kill@6",
            router_chaos="router/handoff:fail@1")
        assert procs[0].wait(timeout=60) == -9
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        _assert_parity(workspace["model"], _original_accepts(dirs), tokens)

    def test_dispatch_site_fault_is_retried(self, workspace, tmp_path):
        tokens, done, rejected, dirs, _ = _run_fleet(
            workspace, tmp_path, router_chaos="router/dispatch:fail@2")
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        _assert_parity(workspace["model"], _original_accepts(dirs), tokens)

    @pytest.mark.parametrize("n", [3, 9])
    def test_decode_kill_sweep_bit_parity(self, workspace, tmp_path, n):
        tokens, done, rejected, dirs, procs = _run_fleet(
            workspace, tmp_path, victim_chaos=f"serve/decode:kill@{n}")
        assert procs[0].wait(timeout=60) == -9
        _assert_exactly_once(done, rejected, tokens,
                             ["r0", "r1", "r2", "r3"])
        _assert_parity(workspace["model"], _original_accepts(dirs), tokens)


class TestChaosTargets:
    def test_serving_targets_are_known(self):
        for target in ("serve/prefill", "serve/prefill_chunk",
                       "serve/decode", "serve/reload",
                       "serve/reload_commit"):
            assert target in chaos.KNOWN_TARGETS
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            chaos.install("serve/decode:kill@999")
        chaos.uninstall()

    def test_router_targets_are_known(self):
        for target in ("router/connect", "router/dispatch",
                       "router/handoff"):
            assert target in chaos.KNOWN_TARGETS
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            chaos.install("router/dispatch:fail@999")
        chaos.uninstall()
