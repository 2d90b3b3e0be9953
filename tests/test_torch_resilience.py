"""The port's fault tolerance (``progen_tpu_torch/resilience/``) and its
checkpoint seams, on the CPU, against the JAX package's.

Held exactly: ``is_transient`` on the JAX package's cases;
``RetryPolicy.delay`` and ``policy_from_env`` under the same seed and
environment (hypothesis-drawn); the verdicts of ``LossSentinel`` and the
proposals of ``PoisonBisector`` on hypothesis-drawn loss streams with
spikes and NaNs injected. ``retry_call`` retries transient faults (the
chaos hook's included) and counts them in ``retry_counts`` and the
registry; the injector counts ``chaos_injections`` and knows this
slice's sites by the JAX names. ``consistent_flag`` and
``per_host_reports`` in two gloo ranks on the CPU. The checkpoint: an
asynchronous save followed by an in-place step and then finalized is
bit-equal to a blocking save of the state before the step;
``check_error`` raises a failed background write (and finalize does);
the file work is retried under its labels; quarantines are counted.
"""

import dataclasses
import errno
import hashlib
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from progen_tpu.resilience import anomaly as janomaly
from progen_tpu.resilience import chaos as jchaos
from progen_tpu.resilience import retry as jretry
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch import checkpoint as tckpt
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.resilience import anomaly, chaos, retry
from progen_tpu_torch.telemetry import get_registry, spans
from progen_tpu_torch.training.step import init_train_state, make_train_step
from torch_grid_worker import spawn

CFG = dict(num_tokens=256, dim=32, depth=2, heads=2, dim_head=16,
           window_size=8, seq_len=32, global_mlp_depth=1, ff_mult=2,
           dtype="float32")


# ------------------------------------------------------------------ retry

def _exceptions():
    svc = type("ServiceUnavailable", (Exception,), {})
    marked = ValueError("marked")
    marked.transient = True
    unmarked = ConnectionResetError("unmarked")
    unmarked.transient = False
    return [ValueError("x"), TypeError("x"), KeyError("x"),
            FileNotFoundError("x"), PermissionError("x"),
            IsADirectoryError("x"), AssertionError("x"),
            ConnectionResetError("x"), TimeoutError("x"),
            InterruptedError("x"), OSError(errno.EIO, "io"),
            OSError(errno.ENOSPC, "full"), OSError("no errno"), svc(),
            type("SomeOtherError", (Exception,), {})(), marked, unmarked,
            retry.TransientError("x"), chaos.ChaosError("x")]


def test_classification_equals_jax():
    got = [retry.is_transient(e) for e in _exceptions()]
    assert got == [jretry.is_transient(e) for e in _exceptions()]
    assert got[:7] == [False] * 7 and all(got[7:11])


@settings(max_examples=60, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31), label=st.sampled_from(
           ["ckpt/io/save", "data/read", "x"]),
       base=st.floats(0.0, 2.0), mult=st.floats(1.0, 4.0),
       cap=st.floats(0.0, 10.0), jitter=st.floats(0.0, 1.0),
       env=st.fixed_dictionaries({}, optional={
           "PROGEN_RETRY_ATTEMPTS": st.sampled_from(["2", "7", "bad"]),
           "PROGEN_RETRY_BASE_S": st.sampled_from(["0.5", "0", "x"]),
           "PROGEN_RETRY_MAX_S": st.sampled_from(["3", "1e-3", ""])}))
def test_policy_and_delays_equal_jax(seed, label, base, mult, cap, jitter,
                                     env):
    kw = dict(base_delay_s=base, multiplier=mult, max_delay_s=cap,
              jitter=jitter, seed=seed)
    ours, theirs = retry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    r1, r2 = (random.Random(f"{seed}:{label}") for _ in range(2))
    assert [ours.delay(a, r1) for a in range(6)] == \
        [theirs.delay(a, r2) for a in range(6)]
    with pytest.MonkeyPatch.context() as mp:
        for k in ("PROGEN_RETRY_ATTEMPTS", "PROGEN_RETRY_BASE_S",
                  "PROGEN_RETRY_MAX_S"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        a, b = retry.policy_from_env(ours), jretry.policy_from_env(theirs)
    fields = ("max_attempts", "base_delay_s", "max_delay_s", "multiplier",
              "jitter", "seed")
    assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]


def test_retry_call_retries_counts_and_emits():
    records, sleeps, calls = [], [], {"n": 0}
    spans.configure(sink=records.append)
    before = get_registry().snapshot().get("retries", 0)
    try:
        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionResetError("blip")
            return "ok"

        assert retry.retry_call(flaky, label="t/flaky",
                                sleep=sleeps.append) == "ok"
    finally:
        spans.configure()
    assert calls["n"] == 3 and len(sleeps) == 2
    assert retry.retry_counts["t/flaky"] >= 2
    assert get_registry().snapshot()["retries"] == before + 2
    evs = [r for r in records if r["ev"] == "retry"]
    assert [e["attempt"] for e in evs] == [1, 2]
    assert evs[0]["error"] == "ConnectionResetError: blip"
    with pytest.raises(ValueError):  # fatal: once
        retry.retry_call(lambda: int("x"), label="t/fatal",
                         sleep=lambda s: None)
    policy = retry.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    n = {"n": 0}

    def always():
        n["n"] += 1
        raise TimeoutError("forever")

    with pytest.raises(TimeoutError):
        retry.retry_call(always, label="t/x", policy=policy,
                         sleep=lambda s: None)
    assert n["n"] == 3
    wrapped = retry.retryable("t/deco")(lambda x: x + 1)
    assert wrapped(1) == 2


def test_chaos_fault_is_retried_through_and_counted():
    chaos.install("ckpt/io/meta_write:fail@1")
    before = get_registry().snapshot().get("chaos_injections", 0)
    try:
        got = retry.retry_call(lambda: 5, label="ckpt/io/meta_write",
                               sleep=lambda s: None)
    finally:
        chaos.uninstall()
    assert got == 5
    assert get_registry().snapshot()["chaos_injections"] == before + 1


def test_known_targets_name_this_slice_as_jax_does():
    slice8 = {"ckpt/finalize", "ckpt/restore", "ckpt/save",
              "ckpt/io/meta_read", "ckpt/io/meta_write", "ckpt/io/restore",
              "ckpt/io/save", "data/read", "train/ckpt", "train/eval",
              "train/rollback", "train/sample", "train/loss"}
    assert slice8 <= chaos.KNOWN_TARGETS and slice8 <= jchaos.KNOWN_TARGETS
    assert not {"data/glob", "train/compile"} & chaos.KNOWN_TARGETS


# --------------------------------------------------------------- anomaly

LOSSES = st.one_of(st.floats(1.0, 3.0),
                   st.sampled_from([float("nan"), float("inf"), 1e9, 40.0]))


@settings(max_examples=80, deadline=None, derandomize=True)
@given(stream=st.lists(st.tuples(LOSSES, st.one_of(
           st.none(), st.floats(0.0, 10.0),
           st.just(float("nan")))), max_size=60),
       factor=st.sampled_from([0.0, 3.0, 6.0]), patience=st.integers(1, 4),
       warmup=st.integers(0, 12))
def test_sentinel_verdicts_equal_jax(stream, factor, patience, warmup):
    ours = anomaly.LossSentinel(factor, patience, warmup)
    theirs = janomaly.LossSentinel(factor, patience, warmup)

    def verdict(sentinel, loss, norm):
        try:  # warmup 0 before any clean sample fails in both packages
            return sentinel.observe(loss, norm)
        except AssertionError:
            return "AssertionError"

    for i, (loss, norm) in enumerate(stream):
        assert verdict(ours, loss, norm) == verdict(theirs, loss, norm)
        if i % 17 == 16:
            ours.reset()
            theirs.reset()
    assert (ours.consecutive, ours.n_anomalies, ours.n_clean) == \
        (theirs.consecutive, theirs.n_anomalies, theirs.n_clean)


@settings(max_examples=80, deadline=None, derandomize=True)
@given(window=st.integers(1, 64), min_step=st.integers(1, 16),
       respikes=st.lists(st.booleans(), max_size=12))
def test_bisector_proposals_equal_jax(window, min_step, respikes):
    ours = anomaly.PoisonBisector(window, min_step)
    theirs = janomaly.PoisonBisector(window, min_step)
    for again in respikes:
        assert ours.propose() == theirs.propose()
        assert (ours.exhausted, ours.salvaged) == \
            (theirs.exhausted, theirs.salvaged)
        if again:
            ours.observe_respike()
            theirs.observe_respike()
    with pytest.raises(ValueError):
        anomaly.PoisonBisector(0)


def test_consistent_flag_and_per_host_goodput_in_two_ranks(tmp_path):
    assert anomaly.consistent_flag(True) and not \
        anomaly.consistent_flag(False)  # one process: the identity
    got = spawn(2, "consistent", tmp_path, 120)
    assert [r["mixed"] for r in got] == [True, True]
    assert [r["none"] for r in got] == [False, False]
    for r in got:
        assert [rep["bucket_s/step"] for rep in r["reports"]] == [1.0, 2.0]
        assert [rep["wall_s"] for rep in r["reports"]] == [4.0, 4.0]


# ------------------------------------------------------------ checkpoint

def _state():
    cfg = ProGenConfig.from_dict(CFG)
    state = init_train_state(cfg, device="cpu", seed=0)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        1, 256, (2, 2, 33)))
    make_train_step()(state, batch)  # moments that are not all zero
    return cfg, state, batch


def _package(cfg, state):
    return Package(next_seq_index=4, state=state, model_config=cfg.to_dict(),
                   run_id="r", train_config=None)


def _digests(path) -> dict:
    return {f: hashlib.sha256((Path(path) / f).read_bytes()).hexdigest()
            for f in ("params.pt", "opt.pt")}


def test_async_save_is_bit_equal_to_a_blocking_save(tmp_path):
    cfg, state, batch = _state()
    _, _, blocking = get_checkpoint_fns(str(tmp_path / "b"))
    _, get_last, background = get_checkpoint_fns(str(tmp_path / "a"),
                                                 async_save=True)
    want = _digests(blocking(_package(cfg, state)))
    path = background(_package(cfg, state))
    make_train_step()(state, batch)  # in place, while the write runs
    background.flush()
    assert _digests(path) == want
    meta = json.loads((Path(path) / "meta.json").read_text())
    assert {k: v[1] for k, v in meta["integrity"].items()} == want
    # the next save finalizes the previous first; the buffers are reused
    buffers = dict(background._async["buffers"])
    p2 = background(_package(cfg, state))
    assert all(background._async["buffers"][k] is v
               for k, v in buffers.items())
    pkg = get_last(device="cpu")  # finalizes, then walks
    assert pkg.path == p2 and pkg.state["step"] == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(pkg.state["params"][k], v)
    background.close()


def test_check_error_raises_a_failed_background_write(tmp_path,
                                                      monkeypatch):
    cfg, state, _ = _state()
    records = []
    spans.configure(sink=records.append)
    before = get_registry().snapshot().get("ckpt_commit_failures", 0)
    _, get_last, save = get_checkpoint_fns(str(tmp_path), async_save=True)
    try:
        save.check_error()  # nothing in flight: a no-op
        monkeypatch.setattr(tckpt.torch, "save", lambda *a, **k: (
            _ for _ in ()).throw(ValueError("disk on fire")))
        save(_package(cfg, state))
        save._async["writer"].join()
        with pytest.raises(ValueError, match="disk on fire"):
            save.check_error()
        save.check_error()  # raised once, then retired
        # the failed write never published: nothing to restore
        monkeypatch.undo()
        assert get_last.peek() is None
        save(_package(cfg, state))
        save._async["writer"].join()
        monkeypatch.setattr(tckpt.torch, "save", lambda *a, **k: (
            _ for _ in ()).throw(ValueError("again")))
        save(_package(cfg, state))
        with pytest.raises(ValueError, match="again"):
            save.flush()  # finalize raises it too
    finally:
        spans.configure()
    failed = [r for r in records if r.get("ev") == "ckpt_commit_failed"]
    assert [r["error"] for r in failed] == ["ValueError: disk on fire",
                                           "ValueError: again"]
    assert get_registry().snapshot()["ckpt_commit_failures"] == before + 2
    assert get_last.peek() is not None  # the good save in between


def test_checkpoint_spans_retries_and_quarantine(tmp_path):
    cfg, state, _ = _state()
    records = []
    spans.configure(sink=records.append)
    chaos.install("ckpt/io/save:fail@1,ckpt/io/meta_read:fail@1,"
                  "ckpt/io/restore:fail@1")
    before = dict(retry.retry_counts)
    try:
        _, get_last, save = get_checkpoint_fns(str(tmp_path))
        path = save(_package(cfg, state))
        assert get_last(device="cpu").path == path
        ck = Path(path) / "params.pt"
        raw = bytearray(ck.read_bytes())
        raw[len(raw) // 2] ^= 0x10  # one bit flipped mid-file
        ck.write_bytes(bytes(raw))
        q0 = get_registry().snapshot().get("ckpt_quarantines", 0)
        assert get_checkpoint_fns(str(tmp_path))[1].peek() is None
    finally:
        chaos.uninstall()
        spans.configure()
    for label in ("ckpt/io/save", "ckpt/io/meta_read", "ckpt/io/restore"):
        assert retry.retry_counts[label] == before.get(label, 0) + 1
    assert get_registry().snapshot()["ckpt_quarantines"] == q0 + 1
    names = [r["span"] for r in records if r.get("ev") == "B"]
    assert names[:2] == ["ckpt/save", "ckpt/restore"]
    assert any(r.get("ev") == "ckpt_quarantine" for r in records)


def test_tfrecord_read_retries_under_data_read(tmp_path):
    from progen_tpu_torch.data.tfrecord import read_tfrecords, \
        tfrecord_writer

    path = str(tmp_path / "x.tfrecord.gz")
    with tfrecord_writer(path) as write:
        for s in (b"MKV", b"AAAA"):
            write(s)
    before = retry.retry_counts.get("data/read", 0)
    chaos.install("data/read:fail@1")
    try:
        assert list(read_tfrecords(path)) == [b"MKV", b"AAAA"]
    finally:
        chaos.uninstall()
    assert retry.retry_counts["data/read"] == before + 1


def test_dataclass_policy_is_frozen():
    with pytest.raises(dataclasses.FrozenInstanceError):
        retry.RetryPolicy().max_attempts = 1
