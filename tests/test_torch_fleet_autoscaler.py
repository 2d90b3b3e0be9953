"""The port's ``fleet/autoscaler.py`` against the JAX package's, and the
port's ``cli.router --autoscale`` on the CPU.

  * ``evaluate_policy`` over a hypothesis sweep of policies, signals,
    streaks and cooldown clocks: the same decision and streak;
  * the stateful ``Autoscaler`` over the same TSDB (one of each package
    reading a ring the port's collector code wrote) through a burst and
    a quiet spell: the same decisions and the same ``ev:"scale"``
    records, read back by ``read_scale_records``;
  * policies load alike from TOML (the port's ``load_toml_config``);
  * ``cli.router --device cpu --spawn 1 --autoscale`` over a
    hand-written TSDB scales up (replica 1 boots with ``--replay``),
    then retires it (SIGTERM after its drain, exit 0), and settles
    every accepted id exactly once.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from progen_tpu.fleet import autoscaler as jax_as
from progen_tpu.telemetry.tsdb import TsdbReader as JaxReader
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch import telemetry as pt_telemetry
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.fleet import autoscaler as pt_as
from progen_tpu_torch.resilience import chaos
from progen_tpu_torch.telemetry.collector import make_sample
from progen_tpu_torch.telemetry.tsdb import RingTSDB, TsdbReader
from progen_tpu_torch.training.step import init_train_state

REPO = Path(__file__).resolve().parents[1]
INF = float("inf")


def _policies(kw):
    return pt_as.ScalingPolicy(**kw), jax_as.ScalingPolicy(**kw)


policy_kw = st.fixed_dictionaries({
    "min_replicas": st.integers(0, 3),
    "queue_low": st.floats(0.0, 5.0),
    "up_sustain": st.integers(1, 4),
    "down_sustain": st.integers(1, 4),
    "up_cooldown_s": st.sampled_from([0.0, 10.0, 30.0]),
    "down_cooldown_s": st.sampled_from([0.0, 5.0, 60.0]),
    "stale_after_s": st.sampled_from([5.0, 15.0]),
    "ttft_p95_high_s": st.sampled_from([0.0, 0.5, 2.0]),
    "itl_p99_high_s": st.sampled_from([0.0, 0.1]),
}).flatmap(lambda kw: st.builds(
    lambda extra_max, band: dict(
        kw, max_replicas=kw["min_replicas"] + extra_max,
        queue_high=kw["queue_low"] + band),
    st.integers(0, 3), st.floats(0.5, 10.0)))

signals = st.one_of(st.none(), st.fixed_dictionaries(
    {"queue": st.floats(0.0, 20.0)},
    optional={"ttft_p95_s": st.floats(0.0, 3.0),
              "itl_p99_s": st.floats(0.0, 0.3)}))


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(kw=policy_kw, sig=signals, current=st.integers(0, 7),
       age=st.floats(0.0, 30.0), last_dir=st.sampled_from([-1, 0, 1]),
       length=st.integers(0, 5),
       since_up=st.one_of(st.just(INF), st.floats(0.0, 100.0)),
       since_down=st.one_of(st.just(INF), st.floats(0.0, 100.0)))
def test_evaluate_policy_sweep_matches(kw, sig, current, age, last_dir,
                                       length, since_up, since_down):
    pt, jx = _policies(kw)
    args = (current, sig, age, (last_dir, length), since_up, since_down)
    got, got_streak = pt_as.evaluate_policy(pt, *args)
    want, want_streak = jax_as.evaluate_policy(jx, *args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got_streak == want_streak


@pytest.mark.parametrize("kw", [
    dict(queue_high=1.0, queue_low=1.0), dict(min_replicas=3,
                                              max_replicas=2),
    dict(up_sustain=0), dict(min_replicas=-1)])
def test_bad_policies_refused_alike(kw):
    for mod in (pt_as, jax_as):
        with pytest.raises(ValueError):
            mod.ScalingPolicy(**kw)


def test_policies_load_alike(tmp_path):
    shipped = REPO / "configs" / "serving" / "autoscaler.toml"
    assert dataclasses.asdict(pt_as.load_policy(shipped)) == \
        dataclasses.asdict(jax_as.load_policy(shipped))
    bad = tmp_path / "bad.toml"
    bad.write_text("[autoscaler]\nqueue_hgih = 3\n")
    errors = []
    for mod in (pt_as, jax_as):
        with pytest.raises(ValueError) as exc:
            mod.load_policy(bad)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def _queue_sample(ts, queue, ttft=None):
    timings = ({"ttft_s": {"count": 4.0, "sum": ttft * 4, "p50_s": ttft,
                           "p95_s": ttft, "p99_s": ttft}}
               if ttft is not None else None)
    return make_sample(ts=ts, source="router", role="router", up=True,
                       age_s=0.1, gauges={"queue_depth": queue},
                       timings=timings)


TRAFFIC = ([(12.0, None)] * 3 + [(5.0, 0.2)] * 2 + [(0.0, 2.5)] * 2
           + [(0.0, None)] * 8 + [(9.0, None)] * 2)


@pytest.mark.parametrize("stale_at", [None, 9])
def test_autoscalers_over_one_tsdb_decide_alike(tmp_path, stale_at):
    policy = dict(min_replicas=1, max_replicas=3, queue_high=8.0,
                  queue_low=1.0, up_sustain=2, down_sustain=2,
                  up_cooldown_s=4.0, down_cooldown_s=6.0,
                  stale_after_s=5.0, ttft_p95_high_s=2.0)
    pt_pol, jax_pol = _policies(policy)
    db = RingTSDB(tmp_path / "tsdb")
    scalers = {
        "port": pt_as.Autoscaler(pt_pol,
                                 reader=TsdbReader(tmp_path / "tsdb")),
        "jax": jax_as.Autoscaler(jax_pol,
                                 reader=JaxReader(tmp_path / "tsdb"))}
    events = tmp_path / "events.jsonl"
    pt_telemetry.configure(path=events)
    current = {"port": 1, "jax": 1}
    trail = {"port": [], "jax": []}
    try:
        for i, (queue, ttft) in enumerate(TRAFFIC):
            now = 100.0 + 2.0 * i
            if i != stale_at:
                db.append(_queue_sample(now, queue, ttft))
            for name, scaler in scalers.items():
                d = scaler.decide(current[name], now=now + 0.5)
                trail[name].append(dataclasses.asdict(d))
                current[name] = d.target
    finally:
        pt_telemetry.configure()
        db.close()
    assert trail["port"] == trail["jax"]
    actions = [d["action"] for d in trail["port"]]
    assert "up" in actions and "down" in actions
    recs = pt_as.read_scale_records(events)
    assert recs == jax_as.read_scale_records(events)
    assert [r["action"] for r in recs if r["action"] != "hold"] == [
        d["action"] for d in trail["port"] if d["action"] != "hold"]


def test_chaos_at_decide_costs_one_tick(tmp_path):
    scaler = pt_as.Autoscaler(pt_as.ScalingPolicy(), reader=None)
    chaos.install("autoscaler/decide:fail@1")
    try:
        with pytest.raises(chaos.ChaosError):
            scaler.decide(1, now=1.0)
    finally:
        chaos.uninstall()
    assert scaler.decide(1, now=1.0).reason == "no_data"


# --------------------------------------------- cli.router --autoscale


def _wait(pred, what, timeout=180.0):
    t = time.monotonic() + timeout
    while time.monotonic() < t:
        if pred():
            return
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


def test_router_autoscales_a_spawned_fleet_on_the_cpu(tmp_path):
    cfg = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2,
                       window_size=8, global_mlp_depth=1, heads=2,
                       dim_head=16, ff_mult=2, dtype="float32")
    state = init_train_state(cfg, device="cpu", seed=2)
    get_checkpoint_fns(str(tmp_path / "ck"))[2](Package(
        next_seq_index=0, state=state, model_config=cfg.to_dict(),
        run_id="autoscale"))
    del state
    policy = tmp_path / "policy.toml"
    policy.write_text(
        "[autoscaler]\nmin_replicas = 1\nmax_replicas = 2\n"
        "queue_high = 3.0\nqueue_low = 1.0\nup_sustain = 1\n"
        "down_sustain = 1\nup_cooldown_s = 0.0\ndown_cooldown_s = 1.0\n"
        "stale_after_s = 600.0\ninterval_s = 0.5\n")
    tsdb = tmp_path / "tsdb"
    db = RingTSDB(tsdb)
    db.append(_queue_sample(time.time(), 9.0))  # the burst
    fleet = tmp_path / "fleet"
    err_path = tmp_path / "router.err"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with err_path.open("w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.router",
             "--device", "cpu", "--spawn", "1", "--checkpoint_path",
             str(tmp_path / "ck"), "--fleet_dir", str(fleet),
             "--max-len", "32", "--replica-max-slots", "1",
             "--autoscale", str(policy), "--autoscale_tsdb", str(tsdb)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err,
            cwd=tmp_path, env=env, text=True)
    out_lines = []
    reader = threading.Thread(
        target=lambda: out_lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        ids = [f"g{i}" for i in range(4)]
        for i, rid in enumerate(ids):
            proc.stdin.write(json.dumps({"id": rid, "prime": "MKV",
                                         "length": 20, "seed": i}) + "\n")
        proc.stdin.flush()
        log1 = fleet / "replica1" / "replica.log"
        _wait(lambda: "replica1: pid" in err_path.read_text(), "scale-up")
        _wait(lambda: log1.exists() and "listening on" in log1.read_text(),
              "replica 1's boot")
        db.append(_queue_sample(time.time(), 0.0))  # the quiet
        _wait(lambda: "replica1: exited" in err_path.read_text(),
              "replica 1's retirement")
        proc.stdin.close()
        assert proc.wait(timeout=180) == 0
    finally:
        db.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    err = err_path.read_text()
    assert "replica1: pid" in err and "(replaying its journal)" in err
    assert "replica1: retiring (scale-down)" in err
    assert "replica1: exited rc=0" in err, err[-3000:]
    events = [json.loads(ln) for ln in out_lines]
    done = [e["id"] for e in events if e.get("event") == "done"]
    assert sorted(done) == sorted(ids), events
    (ev_path,) = (tmp_path / "runs" / "progen-router").glob(
        "*/events.jsonl")
    acts = [r["action"] for r in pt_as.read_scale_records(ev_path)
            if r["action"] != "hold"]
    assert acts == ["up", "down"]
    assert acts == [r["action"] for r in jax_as.read_scale_records(ev_path)
                    if r["action"] != "hold"]


@pytest.mark.parametrize("argv,err", [
    (["--replica", "sock=/s", "--autoscale", "p.toml", "--autoscale_tsdb",
      "t"], "--autoscale needs --spawn"),
    (["--spawn", "1", "--autoscale", "p.toml"],
     "--autoscale needs --autoscale_tsdb DIR"),
    (["--spawn", "1", "--profile_pin", "p"], "unrecognized arguments"),
])
def test_router_refuses_bad_autoscale_flags(argv, err, capsys):
    from progen_tpu_torch.cli import router

    with pytest.raises(SystemExit) as exc:
        router.parse_args(argv)
    assert exc.value.code == 2
    assert err in capsys.readouterr().err


def test_router_accepts_the_slice_flags():
    from progen_tpu_torch.cli import router

    args = router.parse_args([
        "--spawn", "1", "--autoscale", "p.toml", "--autoscale_tsdb", "t",
        "--replica_profile_watch", "--flight_dir", "f"])
    assert (args.autoscale_policy, args.autoscale_tsdb, args.flight_dir,
            args.replica_profile_watch) == ("p.toml", "t", "f", True)
