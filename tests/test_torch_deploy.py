"""The port's continuous deployment (``progen_tpu_torch.deploy``) against
the JAX package's ``progen_tpu.deploy`` on the CPU, and the checkpoint
digest seam its convergence claim rests on.

  * the digest: ``checkpoint_digest`` is stable over two saves of the
    same weights and moves with any byte; ``digest_gauge`` equals the JAX
    function on the same hex strings;
  * the ledger: the same record streams (a torn tail included) fold to
    equal ``LedgerState``s in both packages;
  * the policy: the shipped ``configs/serving/deploy.toml``, bad values
    and unknown keys parse and raise alike;
  * ``probe_stats``: bit-equal over the same shards;
  * the controller: the JAX ``tests/test_deploy.py`` lifecycle, restart,
    probe-gate and probe-determinism cases against the port's controller
    at a tiny config (vocab 256, dim 32, seq_len 32, depth 2, one gMLP
    layer, float32) with ``device="cpu"``;
  * one scenario through both controllers: the same fake clock, the same
    scripted acks, stores holding the same weights (the port's through
    ``flax_params_to_state_dict``). Their ledgers carry the same ops in
    the same order for the same checkpoints and replicas (``ts`` and
    ``digest`` left out, a rollback reason compared up to its numbers),
    and their probe perplexities agree within a relative 1e-5
    (``PPL_RTOL``: the two float32 forwards on the CPU differ in their
    rounding only).

The replicas are directories; the tests play the serve side by writing
acks. The fleet-level version (real ``cli.serve`` replicas, SIGKILLs,
live traffic) is ``tests/test_torch_deploy_kill_matrix.py``.
"""

import dataclasses
import json
import math
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import checkpoint as jckpt
from progen_tpu import config as jcfg
from progen_tpu import deploy as jdeploy
from progen_tpu.telemetry.alerts import AlertSink as JAlertSink
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch import checkpoint as tckpt
from progen_tpu_torch import convert as tconvert
from progen_tpu_torch import deploy as tdeploy
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.deploy import (
    DEPLOY_OPS,
    DeployController,
    DeployLedger,
    DeployPolicy,
    Replica,
    load_deploy_policy,
    probe_stats,
    read_ledger,
    replay_state,
)
from progen_tpu_torch.telemetry.alerts import AlertSink
from progen_tpu_torch.training.optimizer import MaskedAdamW, OptimizerConfig
from progen_tpu_torch.training.state import TrainState
from progen_tpu_torch.workloads import fasta_records, run_batch_score
from tests.test_torch_workloads import numpy_params

BYTE = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
CFG = ProGenConfig(**BYTE)
PPL_RTOL = 1e-5

PROBE_FASTA = """\
>p0 probe
MKTAYIAKQR
>p1 probe
GDSLAVLLTT
>p2 probe
MKVLAAGIAT
>p3 probe
TTQLLASGDK
>p4 probe
MAGWNAYIDN
>p5 probe
LKSVETRGHH
"""


@pytest.fixture(scope="module")
def weights():
    """The port's model on seeded weights (the fleet's A)."""
    return ProGen(CFG, device="cpu", seed=0).eval().state_dict()


def _model(sd):
    m = ProGen(CFG, device="cpu", seed=None)
    m.load_state_dict(sd)
    return m.eval()


def _save(ck, sd, step=0):
    """A checkpoint of the parameters ``sd`` in ``ck``; its name."""
    model = _model(sd)
    state = TrainState(step, model, MaskedAdamW(model, OptimizerConfig()))
    return pathlib.Path(get_checkpoint_fns(str(ck))[2](Package(
        next_seq_index=0, state=state, model_config=CFG.to_dict(),
        run_id="run"))).name


def _scaled(sd, factor):
    return {k: v * factor for k, v in sd.items()}


def _publish(path, text):
    """Write a control file atomically, as a replica would."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with tmp.open("w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _replicas(root, n=3, cls=Replica):
    return [cls(f"replica{i}", pathlib.Path(root) / f"replica{i}")
            for i in range(n)]


def _ack(replica, ckpt, status, reason=""):
    """Play the serve side: answer a pin the way reload.py would."""
    body = {"pin": ckpt, "status": status, "ts": 0.0}
    if reason:
        body["reason"] = reason
    _publish(replica.ack_path, json.dumps(body))


def _ack_pins(replicas):
    """Commit every outstanding pin (the healthy-fleet default)."""
    for r in replicas:
        pin = r.pinned()
        if pin is not None:
            _ack(r, pin, "committed")


class _Clock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _controller(ck, replicas, deploy_dir, **kw):
    kw.setdefault("clock", _Clock())
    kw.setdefault("device", "cpu")
    return DeployController(ck, replicas, deploy_dir, **kw)


@pytest.fixture()
def probe_fasta(tmp_path):
    p = tmp_path / "probe.fa"
    p.write_text(PROBE_FASTA)
    return str(p)


# ----- the digest seam ------------------------------------------------------


class TestDigest:
    def test_identical_weights_agree_any_byte_moves_it(self, tmp_path,
                                                       weights):
        a = _save(tmp_path / "ck", weights)
        b = _save(tmp_path / "ck", weights)
        assert a != b
        da = tckpt.checkpoint_digest(tmp_path / "ck" / a)
        assert da is not None and len(da) == 64
        assert tckpt.checkpoint_digest(tmp_path / "ck" / b) == da
        # one flipped byte in the parameters moves the manifest and so the
        # digest; a moved element value does too
        moved = dict(weights)
        key = next(iter(moved))
        moved[key] = moved[key].clone()
        moved[key].view(-1)[0] += 1.0
        c = _save(tmp_path / "ck", moved)
        assert tckpt.checkpoint_digest(tmp_path / "ck" / c) != da
        params = tmp_path / "ck" / b / "params.pt"
        raw = bytearray(params.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        params.write_bytes(bytes(raw))
        meta = json.loads((tmp_path / "ck" / b / "meta.json").read_text())
        meta["integrity"] = tckpt.digest_manifest(
            tmp_path / "ck" / b, ("params.pt", "opt.pt"))
        _publish(tmp_path / "ck" / b / "meta.json", json.dumps(meta))
        assert tckpt.checkpoint_digest(tmp_path / "ck" / b) != da

    def test_no_meta_is_none_and_manifestless_meta_hashes_whole(self,
                                                               tmp_path):
        assert tckpt.checkpoint_digest(tmp_path / "nothing") is None
        d = tmp_path / "ckpt_1"
        _publish(d / "meta.json", json.dumps({"next_seq_index": 3}))
        got = tckpt.checkpoint_digest(d)
        assert got == jckpt.checkpoint_digest(d)

    @pytest.mark.parametrize("digest", [
        None, "", "0" * 64, "f" * 64, "0123456789abcdef" * 4,
        "ffffffffffff0000", "800000000000"])
    def test_gauge_equals_the_jax_gauge(self, digest):
        got = tckpt.digest_gauge(digest)
        assert got == jckpt.digest_gauge(digest)
        assert got == (-1.0 if not digest else int(digest[:12], 16))

    def test_same_manifest_same_digest_in_both_packages(self, tmp_path,
                                                        weights):
        """The digest is a function of meta.json's manifest alone, the same
        function in both packages."""
        name = _save(tmp_path / "ck", weights)
        assert tckpt.checkpoint_digest(tmp_path / "ck" / name) == \
            jckpt.checkpoint_digest(tmp_path / "ck" / name)


# ----- the ledger, the policy, probe_stats against the JAX package ---------


def _record_stream():
    """A ledger's worth of records: two lifecycles, a rollback, a
    re-observed failed candidate, promotes to several replicas."""
    return [
        ("observed", "ckpt_0", dict(digest="aa", adopted=True)),
        ("converged", "ckpt_0", dict(digest="aa", adopted=True)),
        ("observed", "ckpt_1", dict(digest="bb",
                                    baseline_ttft_p95_s=0.25)),
        ("canary", "ckpt_1", dict(replica="replica0")),
        ("probe", "ckpt_0", dict(ppl=10.0, n=6, tokens=72)),
        ("probe", "ckpt_1", dict(ppl=10.05, n=6, tokens=72)),
        ("promote", "ckpt_1", dict(replica="replica1")),
        ("promote", "ckpt_1", dict(replica="replica2")),
        ("converged", "ckpt_1", dict(digest="bb")),
        ("observed", "ckpt_2", dict(digest="cc")),
        ("canary", "ckpt_2", dict(replica="replica0")),
        ("rollback", "ckpt_2", dict(to="ckpt_1", reason="canary_timeout")),
        ("observed", "ckpt_2", dict(digest="cc")),
        ("observed", "ckpt_3", dict(digest="dd")),
        ("canary", "ckpt_3", dict(replica="replica0")),
    ]


class TestLedgerAgainstJax:
    @pytest.mark.parametrize("cut", [1, 4, 9, 12, 15])
    def test_streams_fold_to_equal_states(self, tmp_path, cut):
        """Each package writes the stream's first ``cut`` records and a
        torn line; both readers read both files and fold equal states."""
        paths = {}
        for name, led_cls in (("torch", DeployLedger),
                              ("jax", jdeploy.DeployLedger)):
            path = tmp_path / name / "deploy.jsonl"
            led = led_cls(path)
            for i, (op, ckpt, fields) in enumerate(_record_stream()[:cut]):
                led.append(op, ckpt, ts=1.0 + i, **fields)
            led.close()
            with open(path, "a", encoding="utf-8") as f:
                f.write('{"ev": "deploy", "op": "conv')
                f.flush()
                os.fsync(f.fileno())
            paths[name] = path
        states = []
        for path in paths.values():
            got = read_ledger(path)
            assert got == jdeploy.read_ledger(path)
            assert [r["op"] for r in got] == \
                [op for op, _, _ in _record_stream()[:cut]]
            states.append(dataclasses.asdict(replay_state(got)))
            states.append(dataclasses.asdict(jdeploy.replay_state(got)))
        assert all(s == states[0] for s in states)

    def test_unknown_op_rejected_alike(self, tmp_path):
        for led_cls in (DeployLedger, jdeploy.DeployLedger):
            led = led_cls(tmp_path / f"{led_cls.__module__}.jsonl")
            with pytest.raises(ValueError, match="unknown deploy op"):
                led.append("shipped", "ckpt_000000")
            led.close()
        assert DEPLOY_OPS == jdeploy.DEPLOY_OPS

    def test_read_missing_ledger_is_empty(self, tmp_path):
        assert read_ledger(tmp_path / "nope.jsonl") == []


class TestPolicyAgainstJax:
    def test_shipped_example_parses_alike(self):
        got = load_deploy_policy("configs/serving/deploy.toml")
        want = jdeploy.load_deploy_policy("configs/serving/deploy.toml")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got == DeployPolicy()  # the example documents defaults

    @pytest.mark.parametrize("kw", [
        {"interval_s": 0.0},
        {"ack_timeout_s": 0.0},
        {"max_ppl_regression_pct": -1.0},
        {"max_ttft_regression_pct": -0.5},
        {"probe_batch_size": 0},
    ])
    def test_bad_values_raise_alike(self, kw):
        with pytest.raises(ValueError) as got:
            DeployPolicy(**kw)
        with pytest.raises(ValueError) as want:
            jdeploy.DeployPolicy(**kw)
        assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("body", [
        "[deploy]\ninterval_s = 0.5\ncanary = \"replica1\"\n"
        "max_ppl_regression_pct = 2.5\nack_timeout_s = 30.0\n",
        "interval_s = 3.0\nprobe_batch_size = 4\n",  # no table: flat
        "[deploy]\nprobe_context = \"[tax=Homo sapiens]\"\n",
    ])
    def test_toml_parses_alike(self, tmp_path, body):
        p = tmp_path / "deploy.toml"
        p.write_text(body)
        assert dataclasses.asdict(load_deploy_policy(p)) == \
            dataclasses.asdict(jdeploy.load_deploy_policy(p))

    @pytest.mark.parametrize("body", [
        "[deploy]\nmax_ppl_regresion_pct = 2.5\n",  # a typo'd knob
        "[deploy]\ninterval_s = 0.0\n",
        "[deploy]\ninterval_s = 1.0\nwhatever = 1\n",
    ])
    def test_bad_toml_raises_alike(self, tmp_path, body):
        p = tmp_path / "deploy.toml"
        p.write_text(body)
        with pytest.raises(ValueError) as got:
            load_deploy_policy(p)
        with pytest.raises(ValueError) as want:
            jdeploy.load_deploy_policy(p)
        assert str(got.value) == str(want.value)


def _write_shard(out_dir, idx, rows):
    _publish(pathlib.Path(out_dir) / f"scores-{idx:05d}.jsonl",
             "".join(json.dumps(r) + "\n" for r in rows))


class TestProbeStats:
    def test_shard_layout_invariant_and_bit_equal_to_jax(self, tmp_path):
        """The same rows split differently across shards (a duplicate
        from a resume re-score included) reduce to the same bits, in
        both packages."""
        rng = np.random.default_rng(3)
        rows = [{"id": f"s{i}", "n_tokens": int(rng.integers(2, 40)),
                 "nll": float(rng.uniform(0.5, 6.0))} for i in range(40)]
        one = tmp_path / "one"
        _write_shard(one, 0, rows)
        split = tmp_path / "split"
        _write_shard(split, 0, rows[25:])
        _write_shard(split, 1, rows[:10] + rows[30:32])  # dups
        _write_shard(split, 2, rows[10:25])
        got = probe_stats(split)
        assert got == probe_stats(one) == jdeploy.probe_stats(split)
        assert got["n"] == 40
        assert got["tokens"] == sum(r["n_tokens"] for r in rows)

    def test_empty_dir_is_infinite_alike(self, tmp_path):
        got = probe_stats(tmp_path / "nothing")
        assert got["ppl"] == float("inf") and got["n"] == 0
        assert got == jdeploy.probe_stats(tmp_path / "nothing")


# ----- the port's controller (the JAX test_deploy.py cases) ----------------


class TestReplica:
    def test_pin_is_idempotent_on_equal_content(self, tmp_path):
        r = Replica("replica0", tmp_path / "replica0")
        assert r.pinned() is None
        assert r.pin("ckpt_000001") is True
        assert r.pinned() == "ckpt_000001"
        assert r.pin("ckpt_000001") is False
        assert r.pin("ckpt_000002") is True

    def test_ack_states(self, tmp_path):
        r = Replica("replica0", tmp_path / "replica0")
        assert r.ack() is None and not r.on("ckpt_000001")
        _ack(r, "ckpt_000001", "committed")
        assert r.on("ckpt_000001")
        assert r.rejected("ckpt_000001") is None
        assert not r.on("ckpt_000002")
        assert r.ack_for("ckpt_000002") is None
        _ack(r, "ckpt_000002", "rejected", "pin_unavailable")
        assert r.rejected("ckpt_000002") == "pin_unavailable"
        assert not r.on("ckpt_000002")

    def test_reads_the_ports_reload_ack(self, tmp_path):
        """The port's reloader writes the ack this seam reads."""
        from progen_tpu_torch.serving.reload import WeightReloader

        r = Replica("replica0", tmp_path / "replica0")
        r.pin("ckpt_7")
        rel = WeightReloader.__new__(WeightReloader)
        rel.pin_path, rel._acked = r.pin_path, None
        rel._write_ack("ckpt_7", "committed")
        assert r.on("ckpt_7")
        rel._write_ack("ckpt_7", "rejected", "digest_mismatch")
        assert r.rejected("ckpt_7") == "digest_mismatch"


class TestControllerLifecycle:
    def _fleet(self, tmp_path, weights, n=3, **kw):
        ck = tmp_path / "ck"
        name_a = _save(ck, weights)
        replicas = _replicas(tmp_path, n)
        ctrl = _controller(ck, replicas, tmp_path / "deploy", **kw)
        return ck, name_a, replicas, ctrl

    def test_fresh_ledger_adopts_newest(self, tmp_path, weights):
        ck, name_a, replicas, ctrl = self._fleet(tmp_path, weights)
        assert ctrl.tick() == "converged"
        assert ctrl.state.fleet == name_a
        assert all(r.pinned() == name_a for r in replicas)
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert [r["op"] for r in recs] == ["observed", "converged"]
        assert all(r.get("adopted") for r in recs)
        assert recs[-1]["digest"] == tckpt.checkpoint_digest(ck / name_a)
        assert ctrl.tick() is None
        ctrl.close()

    def test_empty_store_stays_idle(self, tmp_path):
        ctrl = _controller(tmp_path / "nothing", _replicas(tmp_path, 1),
                           tmp_path / "deploy")
        assert ctrl.tick() is None
        assert ctrl.state.fleet is None
        ctrl.close()

    def test_default_device_is_the_card(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default resolves to it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeployController(tmp_path / "ck", _replicas(tmp_path, 1),
                             tmp_path / "deploy")

    def test_full_promote_is_rolling_and_ordered(self, tmp_path, weights):
        ck, name_a, replicas, ctrl = self._fleet(tmp_path, weights)
        assert ctrl.tick() == "converged"
        name_b = _save(ck, _scaled(weights, 1.5), 1)
        assert ctrl.tick() == "observed"
        assert ctrl.state.candidate == name_b
        assert ctrl.tick() == "canary"
        assert replicas[0].pinned() == name_b
        assert all(r.pinned() == name_a for r in replicas[1:])
        assert ctrl.tick() is None
        _ack(replicas[0], name_b, "committed")
        assert ctrl.tick() == "promote"
        assert replicas[1].pinned() == name_b
        assert replicas[2].pinned() == name_a
        assert ctrl.tick() is None
        _ack(replicas[1], name_b, "committed")
        assert ctrl.tick() == "promote"
        assert replicas[2].pinned() == name_b
        _ack(replicas[2], name_b, "committed")
        assert ctrl.tick() == "converged"
        assert ctrl.state.fleet == name_b
        assert ctrl.state.fleet_digest == tckpt.checkpoint_digest(
            ck / name_b)
        assert ctrl.tick() is None
        ctrl.close()

    def test_canary_rejection_rolls_back_everyone(self, tmp_path,
                                                  weights):
        pages = []
        ck, name_a, replicas, ctrl = self._fleet(
            tmp_path, weights,
            alerts=AlertSink(tmp_path / "alerts.jsonl",
                             relay=pages.append))
        ctrl.tick()  # adopt
        _ack_pins(replicas)
        name_b = _save(ck, _scaled(weights, 2.0), 1)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "rejected", "digest_mismatch")
        assert ctrl.tick() == "rollback"
        assert all(r.pinned() == name_a for r in replicas)
        assert name_b in ctrl.state.failed
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert not any(r["op"] == "promote" for r in recs)
        rb = [r for r in recs if r["op"] == "rollback"]
        assert rb[0]["to"] == name_a
        assert rb[0]["reason"] == "canary_rejected:digest_mismatch"
        assert [p["kind"] for p in pages] == ["deploy_rollback"]
        assert pages[0]["objective"] == name_b
        assert ctrl.tick() is None  # never retried
        assert replicas[0].pinned() == name_a
        ctrl.close()

    def test_canary_ack_timeout_rolls_back(self, tmp_path, weights):
        clock = _Clock()
        ck, name_a, replicas, ctrl = self._fleet(
            tmp_path, weights, policy=DeployPolicy(ack_timeout_s=60.0),
            clock=clock)
        ctrl.tick()  # adopt
        _save(ck, _scaled(weights, 2.0), 1)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        clock.now += 30.0
        assert ctrl.tick() is None
        clock.now += 31.0
        assert ctrl.tick() == "rollback"
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert recs[-1]["reason"] == "canary_timeout"
        ctrl.close()

    def test_promote_rejection_rolls_back(self, tmp_path, weights):
        ck, name_a, replicas, ctrl = self._fleet(tmp_path, weights)
        ctrl.tick()  # adopt
        name_b = _save(ck, _scaled(weights, 3.0), 1)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "committed")
        ctrl.tick()  # promote replica1
        _ack(replicas[1], name_b, "rejected", "incompatible_tree")
        assert ctrl.tick() == "rollback"
        assert all(r.pinned() == name_a for r in replicas)
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert recs[-1]["reason"] == \
            "promote_rejected:replica1:incompatible_tree"
        ctrl.close()

    def test_named_canary_is_honored(self, tmp_path, weights):
        ck, name_a, replicas, ctrl = self._fleet(
            tmp_path, weights, policy=DeployPolicy(canary="replica2"))
        ctrl.tick()  # adopt
        name_b = _save(ck, _scaled(weights, 1.1), 1)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        assert replicas[2].pinned() == name_b
        assert replicas[0].pinned() == name_a
        ctrl.close()

    def test_unknown_canary_name_raises(self, tmp_path, weights):
        ck = tmp_path / "ck"
        _save(ck, weights)
        with pytest.raises(ValueError, match="not in replicas"):
            _controller(ck, _replicas(tmp_path, 2), tmp_path / "deploy",
                        policy=DeployPolicy(canary="replica9"))


class TestControllerRestart:
    """SIGKILL-at-any-phase, in miniature: drop the controller object
    mid-pipeline, rebuild from the ledger, assert it resumes without
    repeating completed work."""

    def _start(self, tmp_path, weights, **kw):
        ck = tmp_path / "ck"
        name_a = _save(ck, weights)
        replicas = _replicas(tmp_path, 3)
        ctrl = _controller(ck, replicas, tmp_path / "deploy", **kw)
        ctrl.tick()  # adopt A
        _ack_pins(replicas)
        name_b = _save(ck, _scaled(weights, 1.5), 1)
        return ck, name_a, name_b, replicas, ctrl

    def test_restart_mid_promote_does_not_repin_or_skip(self, tmp_path,
                                                        weights):
        ck, name_a, name_b, replicas, ctrl = self._start(tmp_path, weights)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "committed")
        ctrl.tick()  # promote replica1 (recorded, not yet acked)
        before = replicas[1].pin_path.stat().st_mtime_ns
        ctrl.close()  # "SIGKILL"

        ctrl2 = _controller(ck, replicas, tmp_path / "deploy")
        assert ctrl2.tick() is None
        assert replicas[1].pin_path.stat().st_mtime_ns == before
        assert replicas[2].pinned() == name_a
        _ack(replicas[1], name_b, "committed")
        assert ctrl2.tick() == "promote"
        assert replicas[2].pinned() == name_b
        _ack(replicas[2], name_b, "committed")
        assert ctrl2.tick() == "converged"
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        promotes = [r for r in recs if r["op"] == "promote"]
        assert sorted(r["replica"] for r in promotes) == \
            ["replica1", "replica2"]
        ctrl2.close()

    def test_restart_mid_canary_keeps_waiting(self, tmp_path, weights):
        ck, name_a, name_b, replicas, ctrl = self._start(tmp_path, weights)
        ctrl.tick()  # observed
        ctrl.tick()  # canary (pin written, no ack yet)
        ctrl.close()
        ctrl2 = _controller(ck, replicas, tmp_path / "deploy")
        assert ctrl2.tick() is None  # no second canary record
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert [r["op"] for r in recs].count("canary") == 1
        _ack(replicas[0], name_b, "committed")
        assert ctrl2.tick() == "promote"
        ctrl2.close()

    def test_rollback_alert_exactly_once_across_restart(self, tmp_path,
                                                        weights):
        pages = []
        sink = AlertSink(tmp_path / "alerts.jsonl", relay=pages.append)
        ck, name_a, name_b, replicas, ctrl = self._start(
            tmp_path, weights, alerts=sink)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "rejected", "digest_mismatch")
        assert ctrl.tick() == "rollback"
        assert len(pages) == 1
        ctrl.close()
        sink.close()
        pages2 = []
        sink2 = AlertSink(tmp_path / "alerts.jsonl", relay=pages2.append)
        ctrl2 = _controller(ck, replicas, tmp_path / "deploy", alerts=sink2)
        assert pages2 == []
        assert sink2.suppressed == 1
        assert ctrl2.tick() is None
        ctrl2.close()
        sink2.close()

    def test_restart_mid_rollback_finishes_the_repins(self, tmp_path,
                                                      weights):
        ck, name_a, name_b, replicas, ctrl = self._start(tmp_path, weights)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "rejected", "digest_mismatch")
        ctrl.tick()  # rollback (all pins back to A)
        ctrl.close()
        replicas[0].pin(name_b)  # the torn rollback's resurrected pin
        ctrl2 = _controller(ck, replicas, tmp_path / "deploy")
        assert ctrl2.tick() is None
        assert all(r.pinned() == name_a for r in replicas)
        ctrl2.close()


class TestProbeGate:
    """The verdict's arithmetic and rollback wiring, with measurements
    planted on the ledger (the real scorer runs in
    TestProbeDeterminism)."""

    def _canaried_fleet(self, tmp_path, weights, policy,
                        probe_fasta="unused.fa"):
        ck = tmp_path / "ck"
        name_a = _save(ck, weights)
        replicas = _replicas(tmp_path, 2)
        ctrl = _controller(ck, replicas, tmp_path / "deploy", policy=policy,
                           probe_fasta=probe_fasta)
        ctrl.tick()  # adopt
        _ack_pins(replicas)
        name_b = _save(ck, _scaled(weights, 1.5), 1)
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "committed")
        return name_a, name_b, replicas, ctrl

    def test_ppl_within_limit_promotes(self, tmp_path, weights):
        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights, DeployPolicy(max_ppl_regression_pct=1.0))
        ctrl._append("probe", name_a, ppl=10.0, n=4, tokens=40)
        ctrl._append("probe", name_b, ppl=10.05, n=4, tokens=40)
        assert ctrl.tick() == "promote"
        assert replicas[1].pinned() == name_b
        ctrl.close()

    def test_ppl_regression_rolls_back(self, tmp_path, weights):
        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights, DeployPolicy(max_ppl_regression_pct=1.0))
        ctrl._append("probe", name_a, ppl=10.0, n=4, tokens=40)
        ctrl._append("probe", name_b, ppl=10.2, n=4, tokens=40)
        assert ctrl.tick() == "rollback"
        assert all(r.pinned() == name_a for r in replicas)
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert recs[-1]["reason"] == "ppl_regression:10.2>10.1"
        ctrl.close()

    def test_ttft_regression_rolls_back(self, tmp_path, weights):
        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights,
            DeployPolicy(max_ppl_regression_pct=50.0,
                         max_ttft_regression_pct=10.0))
        ctrl.state.observed[name_b]["baseline_ttft_p95_s"] = 0.10
        ctrl._fleet_ttft = lambda: 0.15
        ctrl._append("probe", name_a, ppl=10.0, n=4, tokens=40)
        ctrl._append("probe", name_b, ppl=10.0, n=4, tokens=40)
        assert ctrl.tick() == "rollback"
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert recs[-1]["reason"].startswith("ttft_regression:")
        ctrl.close()

    def test_probe_order_fleet_baseline_first(self, tmp_path, weights):
        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights, DeployPolicy())
        probed = []
        ctrl._probe = lambda ckpt: (
            probed.append(ckpt) or {"ppl": 10.0, "n": 1, "tokens": 4})
        assert ctrl.tick() == "probe"
        assert ctrl.tick() == "probe"
        assert probed == [name_a, name_b]
        ctrl.close()

    def test_probe_crash_rolls_back(self, tmp_path, weights):
        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights, DeployPolicy())
        ctrl._append("probe", name_a, ppl=10.0, n=4, tokens=40)

        def boom(ckpt):
            raise RuntimeError("checkpoint not restorable")

        ctrl._probe = boom
        assert ctrl.tick() == "rollback"
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        assert recs[-1]["reason"] == "probe_failed:RuntimeError"
        ctrl.close()

    def test_ttft_guard_reads_the_fleet_series(self, tmp_path, weights):
        """``_fleet_ttft`` reads the collector's fleet series through a
        TSDB reader, as the JAX controller does over the same samples."""
        import types

        from progen_tpu_torch.telemetry.collector import make_sample

        name_a, name_b, replicas, ctrl = self._canaried_fleet(
            tmp_path, weights, DeployPolicy())
        samples = [make_sample(float(i), f"r{i % 2}", "replica", True, 0.0,
                               timings={"ttft_s": {
                                   "count": i + 1, "sum": v * (i + 1),
                                   "p50_s": v / 2, "p95_s": v}})
                   for i, v in enumerate((0.2, 0.4, 0.3))]

        class Reader:
            def read(self):
                return iter(samples)

        ctrl.reader = Reader()
        want = jdeploy.DeployController._fleet_ttft(
            types.SimpleNamespace(reader=Reader()))
        assert want is not None
        assert ctrl._fleet_ttft() == want
        ctrl.reader = None
        assert ctrl._fleet_ttft() is None
        ctrl.close()


class TestProbeDeterminism:
    """Probe NLL/ppl is bit-identical however many controller restarts
    interrupt the scoring."""

    def test_interrupted_probe_resumes_bit_identical(self, tmp_path,
                                                     weights, probe_fasta):
        model = _model(weights)
        full = tmp_path / "full"
        run_batch_score(model, fasta_records(probe_fasta), str(full),
                        batch_size=2, logprobs=False)
        torn = tmp_path / "torn"
        run_batch_score(model, fasta_records(probe_fasta), str(torn),
                        batch_size=2, logprobs=False, max_batches=1)
        partial = probe_stats(torn)
        assert 0 < partial["n"] < 6
        run_batch_score(model, fasta_records(probe_fasta), str(torn),
                        batch_size=2, logprobs=False, resume=True)
        a, b = probe_stats(full), probe_stats(torn)
        assert a["n"] == b["n"] == 6
        assert a["tokens"] == b["tokens"]
        assert a["ppl"] == b["ppl"]  # bitwise

    def test_controller_resumes_torn_probe(self, tmp_path, weights,
                                           probe_fasta):
        ck = tmp_path / "ck"
        name_a = _save(ck, weights)
        replicas = _replicas(tmp_path, 2)
        ctrl = _controller(
            ck, replicas, tmp_path / "deploy",
            policy=DeployPolicy(probe_batch_size=2,
                                max_ppl_regression_pct=100.0),
            probe_fasta=probe_fasta)
        ctrl.tick()  # adopt
        _ack_pins(replicas)
        name_b = _save(ck, weights, 1)  # same weights, a new checkpoint
        ctrl.tick()  # observed
        ctrl.tick()  # canary
        _ack(replicas[0], name_b, "committed")
        run_batch_score(_model(weights), fasta_records(probe_fasta),
                        str(tmp_path / "deploy" / "probes" / name_a),
                        batch_size=2, logprobs=False, max_batches=1)
        assert ctrl.tick() == "probe"  # resumes the torn fleet probe
        assert ctrl.tick() == "probe"  # the candidate's, clean
        recs = read_ledger(tmp_path / "deploy" / "deploy.jsonl")
        probes = {r["ckpt"]: r for r in recs if r["op"] == "probe"}
        assert probes[name_a]["n"] == probes[name_b]["n"] == 6
        assert probes[name_a]["ppl"] == probes[name_b]["ppl"]
        assert ctrl.tick() == "promote"
        ctrl.close()

    def test_probe_equals_a_direct_forward(self, tmp_path, weights,
                                           probe_fasta):
        """The controller's probe ppl is the token-weighted NLL of the
        port's model on the probe records, to float32 summation order."""
        from progen_tpu_torch.data.dataset import collate
        from progen_tpu_torch.training.loss import sequence_scores

        ck = tmp_path / "ck"
        name = _save(ck, weights)
        ctrl = _controller(ck, _replicas(tmp_path, 1), tmp_path / "deploy",
                           probe_fasta=probe_fasta)
        stats = ctrl._probe(name)
        rows = [raw for _, raw in fasta_records(probe_fasta)]
        data = torch.from_numpy(collate(rows, CFG.seq_len)).long()
        with torch.no_grad():
            logits = _model(weights)(data[:, :-1])
        nll, _, mask = sequence_scores(logits, data[:, 1:])
        n_tok = mask.sum(-1).double()
        want = math.exp(float((nll.double() * n_tok).sum() / n_tok.sum()))
        assert stats["n"] == 6 and stats["tokens"] == int(n_tok.sum())
        assert stats["ppl"] == pytest.approx(want, rel=1e-6)
        ctrl.close()


# ----- one scenario through both controllers --------------------------------


def _jax_save(ck, tree, step):
    _, _, save = jckpt.get_checkpoint_fns(str(ck))
    params = jax.tree.map(jnp.asarray, tree)
    return pathlib.Path(save(jckpt.Package(
        step, {"params": params}, jcfg.ProGenConfig(**BYTE).to_dict(),
        "run"))).name


def _scenario(ctrl, replicas, publish, clock):
    """Adopt A; B (A plus a small relative noise) is canaried, probed
    against A and rolled out; C (A's to-logits weight x4) is canaried,
    probed and rolled back. Returns the ledger's records."""
    seen = []

    def tick(want):
        got = ctrl.tick()
        seen.append(got)
        clock.now += 1.0
        assert got == want, (want, seen)

    tick("converged")  # adopt A
    _ack_pins(replicas)
    publish("B")
    tick("observed")
    tick("canary")
    tick(None)  # waiting on the canary
    _ack_pins(replicas[:1])
    tick("probe")  # the fleet baseline A
    tick("probe")  # B
    for replica in replicas[1:]:
        tick("promote")
        tick(None)
        _ack_pins([replica])
    tick("converged")
    publish("C")
    tick("observed")
    tick("canary")
    _ack_pins(replicas[:1])
    tick("probe")  # C (B's probe is the baseline now)
    tick("rollback")
    tick(None)  # never retried
    return read_ledger(ctrl.ledger.path)


def _comparable(recs, names):
    """The records without ts and digest, checkpoints by letter, a
    rollback reason up to its numbers, the probes' ppl apart."""
    out, ppls = [], {}
    for r in recs:
        r = {k: v for k, v in r.items() if k not in ("ts", "digest")}
        for key in ("ckpt", "to"):
            if key in r:
                r[key] = names[r[key]]
        if "reason" in r:
            r["reason"] = r["reason"].split(":")[0]
        if r["op"] == "probe":
            ppls[r["ckpt"]] = r.pop("ppl")
        out.append(r)
    return out, ppls


def test_both_controllers_take_the_same_decisions(tmp_path, probe_fasta):
    tree = numpy_params(jcfg.ProGenConfig(**BYTE), seed=4)
    rng = np.random.default_rng(5)
    trees = {"A": tree,
             "B": jax.tree.map(lambda a: a * (1 + 1e-3 * rng.standard_normal(
                 a.shape).astype(np.float32)), tree),
             "C": jax.tree.map(lambda a: a, tree)}
    trees["C"]["to_logits"] = {k: v * 4.0 for k, v in
                               tree["to_logits"].items()}
    policy = dict(max_ppl_regression_pct=1.0, probe_batch_size=4)
    results = {}
    for pkg in ("jax", "torch"):
        root = tmp_path / pkg
        ck = root / "ck"
        names = {}

        def publish(letter, ck=ck, names=names, pkg=pkg):
            if pkg == "jax":
                name = _jax_save(ck, trees[letter], len(names))
            else:
                name = _save(ck, tconvert.flax_params_to_state_dict(
                    trees[letter], CFG), len(names))
            names[name] = letter

        publish("A")
        clock = _Clock()
        if pkg == "jax":
            replicas = _replicas(root, 3, cls=jdeploy.Replica)
            ctrl = jdeploy.DeployController(
                ck, replicas, root / "deploy",
                jdeploy.DeployPolicy(**policy), probe_fasta=probe_fasta,
                alerts=JAlertSink(root / "alerts.jsonl"), clock=clock)
        else:
            replicas = _replicas(root, 3)
            ctrl = DeployController(
                ck, replicas, root / "deploy", DeployPolicy(**policy),
                probe_fasta=probe_fasta,
                alerts=AlertSink(root / "alerts.jsonl"), clock=clock,
                device="cpu")
        recs = _scenario(ctrl, replicas, publish, clock)
        ctrl.close()
        results[pkg] = _comparable(recs, names)
    (jrecs, jppl), (trecs, tppl) = results["jax"], results["torch"]
    assert trecs == jrecs
    assert [r["op"] for r in trecs] == [
        "observed", "converged", "observed", "canary", "probe", "probe",
        "promote", "promote", "converged", "observed", "canary", "probe",
        "rollback"]
    assert trecs[-1]["reason"] == "ppl_regression"
    assert sorted(tppl) == sorted(jppl) == ["A", "B", "C"]
    for letter in "ABC":
        assert tppl[letter] == pytest.approx(jppl[letter], rel=PPL_RTOL)
    assert tdeploy.__all__ == jdeploy.__all__
