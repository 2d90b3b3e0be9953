"""``cli.train``'s telemetry and resilience on the CPU (``--device cpu``),
on the tiny workspace of ``tests/test_chaos_matrix.py`` (dim 32, depth 2,
window 8, seq_len 32; ``tests/torch_workspace.py``).

Held: an isolated NaN loss (``PROGEN_CHAOS=train/loss:nan@1``) is skipped
with no rollback; three in a row with ``--anomaly_patience 3`` roll back
("anomaly rollback 1/3"), the run completes and leaves a restorable
checkpoint whose cursor moved past the anomaly; the ``anomaly`` and
``anomaly_rollback`` records (step, cursor, bisection skip) equal the
JAX CLI's on the same workspace and spec (one JAX run for the module); a
transient ``ckpt/io/meta_write`` fault is retried through; an
``--async_checkpoint`` run's checkpoints are bit-equal to a blocking
run's, and a failing background write stops the run at the next step;
``--profile_dir`` writes a trace naming the ``train/step`` span;
``--prom_file`` is well-formed exposition with the resilience counters
and goodput, and on the CPU carries no ``mfu`` and no ``hbm``; every flag
of the slice parses. And the fault of the grid phase's records: the
bytes 1F1B's stage 0 holds for backward (``saved_tensors_hooks``, two
gloo ranks) do not grow from M = 4 to M = 8 and stay under GPipe's at
M = 4.
"""

import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch import checkpoint as tckpt
from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.cli import train as ttrain
from progen_tpu_torch.resilience import chaos, retry
from torch_grid_worker import spawn
from torch_workspace import make_workspace

STEPS = 6  # the workspace's 48 training records, 8 a step
# one effective batch of 8 records in micro-batches of 4: the rollback's
# bisector has a window to split
RUN = ["--seq_len", "32", "--batch_size", "4", "--grad_accum_every", "2",
       "--validate_every", "1000", "--sample_every", "1000",
       "--checkpoint_every", "2", "--anomaly_patience", "3"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("train_resilience"))


def _args(ws, ck, *extra, tracked=False):
    return ["--device", "cpu", *([] if tracked else ["--wandb_off"]), *RUN,
            "--num_steps", str(STEPS),
            "--config_path", str(ws / "configs" / "model"),
            "--data_path", str(ws / "train_data"),
            "--checkpoint_path", str(ck), *extra]


def _events(cwd: Path) -> list:
    (run,) = (cwd / "runs" / "progen-training").iterdir()
    return [json.loads(ln) for ln in
            (run / "events.jsonl").read_text().splitlines()]


def _anomaly_records(events) -> list:
    keep = {"anomaly": ("step", "skipped", "consecutive"),
            "anomaly_rollback": ("step", "restored_step", "next_seq_index",
                                 "rollbacks_done", "total_rollbacks",
                                 "bisect_skip", "bisect_window",
                                 "bisect_salvaged")}
    return [{"ev": e["ev"], **{k: e[k] for k in keep[e["ev"]]}}
            for e in events if e.get("ev") in keep]


@pytest.fixture(scope="module")
def rollback_run(ws, tmp_path_factory):
    """The port's run under train/loss:nan@3, with its tracker, output
    and events."""
    cwd = tmp_path_factory.mktemp("port_cwd")
    mp = pytest.MonkeyPatch()
    mp.chdir(cwd)
    mp.setenv("PROGEN_CHAOS", "train/loss:nan@3")
    try:
        import contextlib
        import io

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = ttrain.run(_args(ws, cwd / "ck", tracked=True))
    finally:
        mp.undo()
    return res, out.getvalue(), _events(cwd), cwd / "ck"


@pytest.fixture(scope="module")
def jax_rollback_events(ws, tmp_path_factory):
    """The JAX CLI's records on the same workspace and spec."""
    from click.testing import CliRunner

    from progen_tpu.cli.train import main as jmain

    cwd = tmp_path_factory.mktemp("jax_cwd")
    mp = pytest.MonkeyPatch()
    mp.chdir(cwd)
    mp.setenv("PROGEN_CHAOS", "train/loss:nan@3")
    try:
        res = CliRunner().invoke(jmain, [
            *RUN, "--num_steps", str(STEPS),
            "--config_path", str(ws / "configs" / "model"),
            "--data_path", str(ws / "train_data"),
            "--checkpoint_path", str(cwd / "ck")])
    finally:
        mp.undo()
    assert res.exit_code == 0, res.output
    assert "anomaly rollback 1/3" in res.output
    return _events(cwd)


def test_isolated_nan_is_skipped_without_rollback(ws, tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setenv("PROGEN_CHAOS", "train/loss:nan@1")
    res = ttrain.run(_args(ws, tmp_path / "ck"))
    out = capsys.readouterr().out
    assert "anomaly:" in out
    assert "rollback" not in out.replace("before rollback", "")
    assert res["rollbacks"] == [] and len(res["steps"]) == STEPS
    assert np.isnan(res["steps"][0]["loss"])
    assert chaos._INJECTOR is None  # uninstalled on the way out


def test_persistent_nan_rolls_back_and_completes(rollback_run):
    res, out, events, ck = rollback_run
    assert "anomaly rollback 1/3" in out
    (rb,) = res["rollbacks"]
    pkg = get_checkpoint_fns(str(ck))[1].peek()
    assert pkg is not None and pkg.path == res["saves"][-1]["path"]
    # the cursor moved past the anomaly: the rollback's skip plus the
    # steps trained after it
    after = sum(s["step"] > rb["step"] for s in res["steps"])
    assert pkg.next_seq_index == rb["next_seq_index"] + 8 * after
    assert rb["next_seq_index"] > rb["step"] * 8 - 8
    state = get_checkpoint_fns(str(ck))[1](device="cpu").state
    assert state["step"] == rb["restored_step"] + after


def test_rollback_records_equal_the_jax_cli(rollback_run,
                                            jax_rollback_events):
    got = _anomaly_records(rollback_run[2])
    assert got == _anomaly_records(jax_rollback_events)
    assert [e["ev"] for e in got] == ["anomaly", "anomaly",
                                      "anomaly_rollback"]
    assert got[-1]["bisect_salvaged"] == 4  # half the window kept


def test_goodput_and_exposition_of_the_rollback_run(rollback_run):
    res, _, events, _ = rollback_run
    rep = res["goodput"]
    total = sum(v for k, v in rep.items() if k.startswith("bucket_s/"))
    assert total == pytest.approx(rep["wall_s"], rel=5e-3)
    assert rep["bucket_s/compile"] > 0 and rep["bucket_s/step"] > 0
    (host,) = [e for e in events if e["ev"] == "goodput_host"]
    assert host["host"] == 0
    spans = {e["span"] for e in events if e.get("ev") == "B"}
    assert {"train/step", "train/ckpt", "train/rollback", "ckpt/save",
            "ckpt/restore"} <= spans
    assert all("mfu" not in s for s in res["steps"])  # no CPU peak


def test_transient_meta_write_fault_is_retried_through(ws, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("PROGEN_CHAOS", "ckpt/io/meta_write:fail@1")
    before = retry.retry_counts.get("ckpt/io/meta_write", 0)
    res = ttrain.run(_args(ws, tmp_path / "ck"))
    assert retry.retry_counts["ckpt/io/meta_write"] == before + 1
    assert get_checkpoint_fns(str(tmp_path / "ck"))[1].peek().path == \
        res["saves"][-1]["path"]


def _digest(path) -> str:
    h = hashlib.sha256()
    for f in ("params.pt", "opt.pt"):
        h.update((Path(path) / f).read_bytes())
    return h.hexdigest()


def test_async_checkpoints_equal_blocking_ones(ws, tmp_path):
    a = ttrain.run(_args(ws, tmp_path / "a", "--async_checkpoint"))
    b = ttrain.run(_args(ws, tmp_path / "b"))
    assert len(a["saves"]) == len(b["saves"]) == STEPS // 2 + 1  # + final
    for x, y in zip(a["saves"], b["saves"]):
        assert _digest(x["path"]) == _digest(y["path"])
    assert [s["loss"] for s in a["steps"]] == [s["loss"] for s in b["steps"]]


def test_a_failing_background_write_stops_the_run(ws, tmp_path,
                                                  monkeypatch):
    def broken(*a, **k):
        raise ValueError("disk on fire")

    monkeypatch.setattr(tckpt.torch, "save", broken)
    with pytest.raises(ValueError, match="disk on fire"):
        ttrain.run(_args(ws, tmp_path / "ck", "--async_checkpoint"))
    monkeypatch.undo()
    assert get_checkpoint_fns(str(tmp_path / "ck"))[1].peek() is None


def test_profile_dir_traces_the_step_span(ws, tmp_path):
    res = ttrain.run(_args(ws, tmp_path / "ck", "--profile_dir",
                           str(tmp_path / "prof")))
    (trace,) = (tmp_path / "prof").glob("*.json")
    assert res["profile"]["path"] == str(trace)
    assert res["profile"]["first_step"] == 3
    names = {e.get("name") for e in json.loads(trace.read_text())
             ["traceEvents"]}
    assert "train/step" in names


PROM_LINE = re.compile(
    r'^(# TYPE progen_train_[a-zA-Z0-9_:]+ (counter|gauge|summary)'
    r'|progen_train_[a-zA-Z0-9_:]+(\{quantile="[0-9.]+"\})? '
    r'(NaN|[+-]Inf|-?[0-9.e+-]+))$')


def test_prom_file_is_well_formed(ws, tmp_path):
    prom = tmp_path / "train.prom"
    ttrain.run(_args(ws, tmp_path / "ck", "--prom_file", str(prom),
                     "--validate_every", "2"))
    text = prom.read_text()
    bad = [ln for ln in text.splitlines() if not PROM_LINE.match(ln)]
    assert not bad, bad
    for name in ("retries_total", "anomalies_total",
                 "anomaly_rollbacks_total", "chaos_injections_total",
                 "stalls_total", "ckpt_commit_failures_total",
                 "goodput_pct", "coverage_pct", "bucket_s_step",
                 "tokens_per_sec_per_chip", "step_seconds_count"):
        assert re.search(rf"^progen_train_{name} ", text, re.M), name
    assert "progen_train_mfu" not in text and "hbm" not in text


@pytest.mark.parametrize("flag", [
    ["--async_checkpoint"], ["--profile_dir", "p"], ["--stall_timeout", "1"],
    ["--stall_escalate_after", "1"], ["--anomaly_factor", "1"],
    ["--anomaly_patience", "1"], ["--prom_file", "p"], ["--prom_port", "1"],
], ids=lambda f: f[0])
def test_slice_flag_is_accepted(flag):
    args = ttrain.parse_args(flag)
    assert getattr(args, flag[0][2:]) == (True if len(flag) == 1 else
                                          type(getattr(args, flag[0][2:]))(
                                              flag[1]))


def test_1f1b_stage0_saved_bytes_do_not_grow_with_microbatches(tmp_path):
    cfg = dict(num_tokens=32, dim=32, seq_len=32, depth=5, window_size=8,
               heads=4, dim_head=8, global_mlp_depth=1, ff_mult=2,
               dtype="float32", scan_layers=True, remat=False)
    batch = torch.from_numpy(np.random.default_rng(5).integers(
        1, 32, (1, 8, 33))).long()
    torch.save({"config": cfg, "batch": batch}, tmp_path / "inputs.pt")
    runs = [("gpipe", 4), ("1f1b", 4), ("1f1b", 8)]
    ranks = spawn(2, "saved_bytes", tmp_path, 120, runs)
    stage0 = ranks[0]
    assert stage0["1f1b", 8] <= stage0["1f1b", 4] <= stage0["gpipe", 4]
    assert stage0["1f1b", 4] > 0
