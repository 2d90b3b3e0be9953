"""The deploy kill matrix against the port's CLIs on the CPU: the
scenarios of ``tests/test_deploy_kill_matrix.py`` with real ``python -m
progen_tpu_torch.cli.serve --device cpu --reload_pin`` replicas, one
``progen_tpu_torch.cli.router`` front and ``progen_tpu_torch.cli.deploy
--device cpu`` as the controller, on checkpoints saved by the port
(vocab 256, dim 32, seq_len 32, depth 2, window 8, one gMLP layer,
float32; B is A's weights x 1.5). The invariants:

  1. the fleet converges to exactly ONE checkpoint digest, read through
     each replica's ``progen_serve_checkpoint_digest`` gauge (and the
     router's ``replica{i}_checkpoint_digest``): the new one when the
     pipeline completes, the old one when it rolls back;
  2. every request the fleet accepted settles exactly once across every
     wave, with no (request, index) token twice;
  3. traffic before the deploy is bit-equal to the port's
     ``sample_fast`` on the OLD weights, traffic after convergence to the
     NEW weights (after a rollback: still the old);
  4. a rollback pages ``deploy_rollback`` through the alert sink exactly
     once, and the condemned candidate is never retried.

In tier 1: the controller SIGKILLed entering its first promote (a
restart replays the ledger, re-pins nothing already pinned and
converges), and the canary SIGKILLed inside its pinned reload (the ack
times out and the fleet rolls back). Marked ``slow``, as the JAX matrix
marks them: the controller killed entering the canary, and a follower
killed inside its promote reload.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.checkpoint import (
    Package,
    checkpoint_digest,
    digest_gauge,
    get_checkpoint_fns,
)
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.telemetry.trace import iter_jsonl
from progen_tpu_torch.training.optimizer import MaskedAdamW, OptimizerConfig
from progen_tpu_torch.training.state import TrainState
from progen_tpu_torch.training.step import init_train_state
from tests.test_torch_fleet_kill_matrix import (
    TINY,
    _assert_exactly_once,
    _assert_parity,
    _env,
    _original_accepts,
    _parse_events,
    _pump,
    _stop,
    _terminate,
    _wait_up,
)

ACK_TIMEOUT_S = 10.0  # the rollback cases' policy: production's is 120


@pytest.fixture(scope="module")
def weights():
    """A's and B's parameters (B = A x 1.5)."""
    cfg = ProGenConfig(**TINY)
    state = init_train_state(cfg, device="cpu", seed=3)
    with torch.no_grad():  # an SGU mix that matters at this size
        w = state.model.ff[1].sgu.spatial_weights
        w.copy_(torch.randn(w.shape, generator=torch.Generator()
                            .manual_seed(3)) / 6)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    return {"cfg": cfg, "a": sd, "b": {k: v * 1.5 for k, v in sd.items()}}


def _save(ck, weights, which, step):
    model = ProGen(weights["cfg"], device="cpu", seed=None)
    model.load_state_dict(weights[which])
    state = TrainState(step, model, MaskedAdamW(model, OptimizerConfig()))
    return Path(get_checkpoint_fns(str(ck))[2](Package(
        next_seq_index=0, state=state,
        model_config=weights["cfg"].to_dict(), run_id="dkm"))).name


def _spawn_pinned_replica(ck, rdir, *, chaos_spec=""):
    """A cli.serve replica that honours its ``reload.pin`` control file,
    the deploy controller's per-replica seam; stderr to rdir/stderr.log."""
    rdir = Path(rdir)
    rdir.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         "cpu", "--checkpoint_path", str(ck), "--max-slots", "2",
         "--max-queue", "16", "--max-len", "24", "--socket",
         str(rdir / "serve.sock"), "--journal_dir", str(rdir),
         "--prom_file", str(rdir / "metrics.prom"), "--metrics-every", "2",
         "--heartbeat", "0.5", "--reload_watch", "0.5", "--reload_pin",
         str(rdir / "reload.pin")],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=open(rdir / "stderr.log", "a"), env=_env(chaos_spec),
        cwd=rdir)


def _spawn_router(rdirs, cwd):
    """cli.router over the replicas' sockets, stdin held open, its
    exposition in cwd/router.prom."""
    cmd = [sys.executable, "-m", "progen_tpu_torch.cli.router",
           "--prom_file", str(Path(cwd) / "router.prom"),
           "--metrics-every", "5"]
    for rdir in rdirs:
        cmd += ["--replica", f"sock={rdir / 'serve.sock'},journal={rdir},"
                f"prom={rdir / 'metrics.prom'}"]
    return subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, bufsize=1, env=_env(), cwd=cwd)


def _spawn_controller(ck, rdirs, deploy_dir, *, chaos_spec="", alerts=None,
                      policy=None, interval=0.3):
    """cli.deploy over explicit --replica name=DIR specs; stderr appended
    to deploy_dir/controller.log across restarts."""
    deploy_dir = Path(deploy_dir)
    deploy_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "progen_tpu_torch.cli.deploy", "--device",
           "cpu", "--checkpoint_path", str(ck), "--deploy_dir",
           str(deploy_dir), "--interval", str(interval)]
    for i, rdir in enumerate(rdirs):
        cmd += ["--replica", f"replica{i}={rdir}"]
    if alerts is not None:
        cmd += ["--alerts", str(alerts)]
    if policy is not None:
        cmd += ["--policy", str(policy)]
    return subprocess.Popen(
        cmd, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=open(deploy_dir / "controller.log", "a"),
        env=_env(chaos_spec), cwd=deploy_dir)


def _ledger(deploy_dir):
    path = Path(deploy_dir) / "deploy.jsonl"
    if not path.exists():
        return []
    return [r for r in iter_jsonl(path) if r.get("ev") == "deploy"]


def _wait(pred, timeout_s, what, log=None):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    tail = Path(log).read_text()[-2000:] if log and Path(log).exists() \
        else ""
    pytest.fail(f"never saw {what}\n{tail}")


def _wait_ledger(deploy_dir, op, ckpt, timeout_s):
    return _wait(lambda: any(r["op"] == op and r["ckpt"] == ckpt
                             for r in _ledger(deploy_dir))
                 and _ledger(deploy_dir), timeout_s, f"{op} {ckpt}",
                 Path(deploy_dir) / "controller.log")


def _ack_of(rdir):
    try:
        return json.loads((Path(rdir) / "reload.pin.ack").read_text())
    except (OSError, ValueError):
        return None


def _gauge(path, name):
    try:
        text = Path(path).read_text()
    except OSError:
        return None
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return None if m is None else float(m.group(1))


def _digest_of(ck, name):
    return digest_gauge(checkpoint_digest(Path(ck) / name))


def _send_wave(router, ids, length=16):
    router.stdin.write("".join(
        json.dumps({"id": rid, "prime": "MKV", "length": length,
                    "seed": 70 + j}) + "\n" for j, rid in enumerate(ids)))
    router.stdin.flush()


def _wait_done(router, out, err, ids, timeout_s=240):
    def settled():
        _, done, rejected = _parse_events(out)
        return set(ids) <= set(done) | {r["id"] for r in rejected}

    assert _pump(router, out, err, settled, timeout_s), \
        f"wave {ids} never settled:\n" + "\n".join(err)[-2000:]


def _close_router(router, out, err):
    router.stdin.close()  # EOF drains
    assert _pump(router, out, err,
                 lambda: all(t[2] for t in router._pump_tails.values()),
                 240), "\n".join(err)[-2000:]
    assert router.wait(timeout=60) == 0, "\n".join(err)[-2000:]


def _wave_parity(ck, name, rdirs, tokens, ids):
    """The tokens of ``ids`` equal sample_fast on checkpoint ``name``."""
    model, _ = load_model(str(ck), torch.device("cpu"), at=name)
    originals = _original_accepts(rdirs)
    assert set(ids) <= set(originals), (ids, sorted(originals))
    _assert_parity(model, {i: originals[i] for i in ids},
                   [t for t in tokens if t[0] in ids])


def _alert_kinds(path):
    if not Path(path).exists():
        return []
    return [(r.get("kind"), r.get("objective")) for r in iter_jsonl(path)
            if r.get("ev") == "alert"]


def _rollback_policy(tmp_path):
    p = tmp_path / "deploy_policy.toml"
    p.write_text(f"[deploy]\nack_timeout_s = {ACK_TIMEOUT_S}\n")
    return p


def _kill_all(*procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def _summary(deploy_dir):
    """The controller's closing line: its launches (none on the CPU)."""
    log = (Path(deploy_dir) / "controller.log").read_text()
    m = re.findall(r"^deploy: \d+ ticks, .* launches (\{.*\})$", log, re.M)
    assert m, log[-2000:]
    return json.loads(m[-1])


class TestDeployKillMatrix:
    def test_controller_sigkill_mid_promote_converges(self, weights,
                                                      tmp_path):
        """The controller dies entering its first promote: after the
        canary committed the candidate, before the rest of the fleet was
        told. A restart replays the ledger, leaves the canary's pin as it
        is, and finishes the rollout: one fleet-wide digest, nothing
        lost, each wave bit-equal to its weights."""
        ck = tmp_path / "ck"
        name_a = _save(ck, weights, "a", 0)
        rdirs = [tmp_path / "r0", tmp_path / "r1"]
        deploy_dir = tmp_path / "deploy"
        procs = [_spawn_pinned_replica(ck, rd) for rd in rdirs]
        router = ctrl = ctrl2 = None
        out, err = [], []
        try:
            for p, rd in zip(procs, rdirs):
                _wait_up(p, rd)
            router = _spawn_router(rdirs, tmp_path)
            ctrl = _spawn_controller(ck, rdirs, deploy_dir,
                                     chaos_spec="deploy/promote:kill@1")
            _wait_ledger(deploy_dir, "converged", name_a, 120)  # adopt
            wave1 = [f"w1-{i}" for i in range(4)]
            _send_wave(router, wave1)
            _wait_done(router, out, err, wave1)

            name_b = _save(ck, weights, "b", 1)
            wave2 = [f"w2-{i}" for i in range(4)]
            _send_wave(router, wave2, length=20)
            # the canary converts replica0, then the first promote span
            # SIGKILLs the controller
            assert ctrl.wait(timeout=240) == -9
            _wait_done(router, out, err, wave2)
            ack = _ack_of(rdirs[0])  # the canary committed before
            assert ack["pin"] == name_b and ack["status"] == "committed"
            canary_pin = (rdirs[0] / "reload.pin").stat().st_mtime_ns

            ctrl2 = _spawn_controller(ck, rdirs, deploy_dir)
            _wait_ledger(deploy_dir, "converged", name_b, 240)
            wave3 = [f"w3-{i}" for i in range(4)]
            _send_wave(router, wave3)
            _wait_done(router, out, err, wave3)
            want = _digest_of(ck, name_b)
            _wait(lambda: all(_gauge(
                tmp_path / "router.prom",
                f"progen_router_replica{i}_checkpoint_digest") == want
                for i in range(2)), 60, "the router's digest gauges")
            _close_router(router, out, err)
            ctrl2.terminate()
            assert ctrl2.wait(timeout=120) == 0
            rcs = [_stop(p) for p in procs]
        finally:
            _kill_all(router, ctrl, ctrl2, *procs)

        tokens, done, rejected = _parse_events(out)
        all_ids = wave1 + wave2 + wave3
        _assert_exactly_once(done, rejected, tokens, all_ids)
        recs = _ledger(deploy_dir)
        ops = [r["op"] for r in recs]
        assert ops.count("canary") == 1 and "rollback" not in ops
        assert [r["replica"] for r in recs if r["op"] == "promote"] == \
            ["replica1"]
        # the restart re-pinned nothing already pinned
        assert (rdirs[0] / "reload.pin").stat().st_mtime_ns == canary_pin
        for rd in rdirs:
            ack = _ack_of(rd)
            assert ack["pin"] == name_b and ack["status"] == "committed"
            assert _gauge(rd / "metrics.prom",
                          "progen_serve_checkpoint_digest") == want
        assert rcs == [0, 0]
        assert all(v == 0 for v in _summary(deploy_dir).values())
        _wave_parity(ck, name_a, rdirs, tokens, wave1)
        _wave_parity(ck, name_b, rdirs, tokens, wave3)

    def test_canary_replica_sigkill_mid_reload_rolls_back(self, weights,
                                                          tmp_path):
        """The canary dies inside its pinned reload, before the candidate
        ever committed. The controller times out the ack, rolls back and
        pages once; the candidate never serves: every wave is bit-equal to
        the OLD weights, the dead canary's work handed to the survivor."""
        ck = tmp_path / "ck"
        name_a = _save(ck, weights, "a", 0)
        rdirs = [tmp_path / "r0", tmp_path / "r1"]
        deploy_dir = tmp_path / "deploy"
        alerts = tmp_path / "alerts.jsonl"
        # replica0's first background reload is the canary pin (the
        # adopt pin names the checkpoint it already serves)
        procs = [_spawn_pinned_replica(ck, rdirs[0],
                                       chaos_spec="serve/reload:kill@1"),
                 _spawn_pinned_replica(ck, rdirs[1])]
        router = ctrl = None
        out, err = [], []
        try:
            for p, rd in zip(procs, rdirs):
                _wait_up(p, rd)
            router = _spawn_router(rdirs, tmp_path)
            ctrl = _spawn_controller(ck, rdirs, deploy_dir, alerts=alerts,
                                     policy=_rollback_policy(tmp_path))
            _wait_ledger(deploy_dir, "converged", name_a, 120)
            wave1 = [f"w1-{i}" for i in range(4)]
            _send_wave(router, wave1)
            _wait_done(router, out, err, wave1)

            name_b = _save(ck, weights, "b", 1)
            wave2 = [f"w2-{i}" for i in range(4)]
            _send_wave(router, wave2, length=20)
            assert procs[0].wait(timeout=240) == -9
            _wait_done(router, out, err, wave2)
            recs = _wait_ledger(deploy_dir, "rollback", name_b, 120)
            rb = [r for r in recs if r["op"] == "rollback"]
            assert rb[0]["to"] == name_a
            assert rb[0]["reason"] == "canary_timeout"

            wave3 = [f"w3-{i}" for i in range(4)]
            _send_wave(router, wave3)
            _wait_done(router, out, err, wave3)
            time.sleep(2.0)  # a few more ticks: B is never retried
            ctrl.terminate()
            assert ctrl.wait(timeout=120) == 0
            _close_router(router, out, err)
            rc_survivor = _stop(procs[1])
        finally:
            _terminate(procs[1])
            _kill_all(router, ctrl, *procs)

        tokens, done, rejected = _parse_events(out)
        all_ids = wave1 + wave2 + wave3
        _assert_exactly_once(done, rejected, tokens, all_ids)
        ops = [r["op"] for r in _ledger(deploy_dir)]
        assert ops.count("canary") == 1 and ops.count("rollback") == 1
        assert "promote" not in ops
        assert _alert_kinds(alerts) == [("deploy_rollback", name_b)]
        ack = _ack_of(rdirs[1])
        assert ack["pin"] == name_a and ack["status"] == "committed"
        assert rc_survivor == 0
        assert _gauge(rdirs[1] / "metrics.prom",
                      "progen_serve_checkpoint_digest") == \
            _digest_of(ck, name_a)
        _wave_parity(ck, name_a, rdirs, tokens, all_ids)


@pytest.mark.slow
class TestDeployKillMatrixSlow:
    def test_controller_sigkill_mid_canary_resumes(self, weights,
                                                   tmp_path):
        """The controller dies entering the canary span, before the pin
        or its record exist. The restart replays an observed-only ledger
        and runs the whole pipeline: one canary record in all,
        convergence to the candidate, nothing lost."""
        ck = tmp_path / "ck"
        name_a = _save(ck, weights, "a", 0)
        rdirs = [tmp_path / "r0", tmp_path / "r1"]
        deploy_dir = tmp_path / "deploy"
        procs = [_spawn_pinned_replica(ck, rd) for rd in rdirs]
        router = ctrl = ctrl2 = None
        out, err = [], []
        try:
            for p, rd in zip(procs, rdirs):
                _wait_up(p, rd)
            router = _spawn_router(rdirs, tmp_path)
            ctrl = _spawn_controller(ck, rdirs, deploy_dir,
                                     chaos_spec="deploy/canary:kill@1")
            _wait_ledger(deploy_dir, "converged", name_a, 120)
            wave1 = [f"w1-{i}" for i in range(4)]
            _send_wave(router, wave1)
            _wait_done(router, out, err, wave1)
            name_b = _save(ck, weights, "b", 1)
            wave2 = [f"w2-{i}" for i in range(4)]
            _send_wave(router, wave2, length=20)
            assert ctrl.wait(timeout=240) == -9
            ctrl2 = _spawn_controller(ck, rdirs, deploy_dir)
            _wait_ledger(deploy_dir, "converged", name_b, 240)
            _wait_done(router, out, err, wave2)
            wave3 = [f"w3-{i}" for i in range(4)]
            _send_wave(router, wave3)
            _wait_done(router, out, err, wave3)
            _close_router(router, out, err)
            ctrl2.terminate()
            assert ctrl2.wait(timeout=120) == 0
            rcs = [_stop(p) for p in procs]
        finally:
            _kill_all(router, ctrl, ctrl2, *procs)

        tokens, done, rejected = _parse_events(out)
        _assert_exactly_once(done, rejected, tokens, wave1 + wave2 + wave3)
        ops = [r["op"] for r in _ledger(deploy_dir)]
        assert ops.count("canary") == 1 and "rollback" not in ops
        want = _digest_of(ck, name_b)
        for rd in rdirs:
            ack = _ack_of(rd)
            assert ack["pin"] == name_b and ack["status"] == "committed"
            assert _gauge(rd / "metrics.prom",
                          "progen_serve_checkpoint_digest") == want
        assert rcs == [0, 0]
        _wave_parity(ck, name_a, rdirs, tokens, wave1)
        _wave_parity(ck, name_b, rdirs, tokens, wave3)

    def test_follower_replica_sigkill_mid_promote_rolls_back(self, weights,
                                                             tmp_path):
        """A non-canary replica dies inside its promote reload. The
        promote ack times out, the rollback swings the canary back to the
        fleet checkpoint, and the surviving fleet ends on the OLD
        digest."""
        ck = tmp_path / "ck"
        name_a = _save(ck, weights, "a", 0)
        rdirs = [tmp_path / "r0", tmp_path / "r1"]
        deploy_dir = tmp_path / "deploy"
        alerts = tmp_path / "alerts.jsonl"
        procs = [_spawn_pinned_replica(ck, rdirs[0]),
                 _spawn_pinned_replica(ck, rdirs[1],
                                       chaos_spec="serve/reload:kill@1")]
        router = ctrl = None
        out, err = [], []
        try:
            for p, rd in zip(procs, rdirs):
                _wait_up(p, rd)
            router = _spawn_router(rdirs, tmp_path)
            ctrl = _spawn_controller(ck, rdirs, deploy_dir, alerts=alerts,
                                     policy=_rollback_policy(tmp_path))
            _wait_ledger(deploy_dir, "converged", name_a, 120)
            wave1 = [f"w1-{i}" for i in range(4)]
            _send_wave(router, wave1)
            _wait_done(router, out, err, wave1)
            name_b = _save(ck, weights, "b", 1)
            wave2 = [f"w2-{i}" for i in range(4)]
            _send_wave(router, wave2, length=20)
            assert procs[1].wait(timeout=240) == -9
            _wait_done(router, out, err, wave2)
            recs = _wait_ledger(deploy_dir, "rollback", name_b, 120)
            rb = [r for r in recs if r["op"] == "rollback"][0]
            assert rb["reason"] == "promote_timeout:replica1"
            _wait(lambda: (_ack_of(rdirs[0]) or {}).get("pin") == name_a
                  and _ack_of(rdirs[0]).get("status") == "committed", 120,
                  "the canary back on A")
            wave3 = [f"w3-{i}" for i in range(4)]
            _send_wave(router, wave3)
            _wait_done(router, out, err, wave3)
            ctrl.terminate()
            assert ctrl.wait(timeout=120) == 0
            _close_router(router, out, err)
            rc_survivor = _stop(procs[0])
        finally:
            _terminate(procs[0])
            _kill_all(router, ctrl, *procs)

        tokens, done, rejected = _parse_events(out)
        _assert_exactly_once(done, rejected, tokens, wave1 + wave2 + wave3)
        assert _alert_kinds(alerts) == [("deploy_rollback", name_b)]
        ack = _ack_of(rdirs[0])
        assert ack["pin"] == name_a and ack["status"] == "committed"
        assert rc_survivor == 0
        assert _gauge(rdirs[0] / "metrics.prom",
                      "progen_serve_checkpoint_digest") == \
            _digest_of(ck, name_a)
        _wave_parity(ck, name_a, rdirs, tokens, wave1)
        _wave_parity(ck, name_a, rdirs, tokens, wave3)
