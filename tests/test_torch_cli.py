"""The port's CLIs (``progen_tpu_torch.cli``) on the CPU at the size of
``tests/test_cli.py`` (dim 32, depth 2, window 8, seq_len 32): training
2N steps equals training N, saving, resuming and training N, bit for bit
(losses, parameters, moments, count, step, cursor); the dtype rule; a
cosine schedule and a shuffle seed surviving a resume without flags;
``--new``; unported flags rejected; no silent fall back to the CPU; a
SIGTERM mid-run in a subprocess; eval and sample; and the naive sampler
against ``sample_fast`` with the same injected noise (exact: the same
draws over logits of two forwards that agree within float32 rounding).
"""

import io
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.cli import eval as teval
from progen_tpu_torch.cli import sample as tsample
from progen_tpu_torch.cli import train as ttrain
from progen_tpu_torch.data.dataset import iterator_from_tfrecords_folder
from progen_tpu_torch.sampling import (
    sample,
    sample_batched,
    sample_fast,
    sample_fast_batched,
)
from torch_workspace import TOML, make_workspace, train_args

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("torch_cli"))


def _state_tensors(state) -> dict:
    out = {f"param:{k}": v for k, v in state.model.state_dict().items()}
    for name in ("mu", "nu"):
        out.update({f"{name}:{k}": v
                    for k, v in getattr(state.optimizer, name).items()})
    return out


def test_resume_is_bit_equal_to_one_run(ws):
    cadence = ["--validate_every", "1", "--sample_every", "3",
               "--checkpoint_every", "2"]
    whole = ttrain.run(train_args(ws, "ck_whole", "--num_steps", "4",
                                  *cadence))
    first = ttrain.run(train_args(ws, "ck_split", "--num_steps", "2",
                                  *cadence))
    second = ttrain.run(train_args(ws, "ck_split", "--num_steps", "2",
                                   *cadence))
    assert second["start_seq_index"] == first["next_seq_index"] == 16
    assert [s["loss"] for s in first["steps"] + second["steps"]] == \
        [s["loss"] for s in whole["steps"]]
    assert [s["step"] for s in second["steps"]] == [3, 4]
    assert second["next_seq_index"] == whole["next_seq_index"] == 32
    a, b = whole["state"], second["state"]
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count) == (4, 4)
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    # the cadences count i from 0 in each run: valid at every step,
    # samples at i = 0 (and 3 in the whole run)
    assert len(second["valid_losses"]) == 2
    assert [s["step"] for s in whole["samples"]] == [1, 4]
    assert [s["step"] for s in second["samples"]] == [3]
    # checkpoints at i = 0 and i = 2, then the final one
    assert len(whole["saves"]) == 3


def test_resume_takes_the_record_after_the_cursor(ws):
    first = ttrain.run(train_args(ws, "ck_cursor", "--num_steps", "3"))
    second = ttrain.run(train_args(ws, "ck_cursor", "--num_steps", "1"))
    n, iter_fn = iterator_from_tfrecords_folder(str(ws / "train_data"))
    stream = iter_fn(32, 4, loop=True)
    batches = [next(stream) for _ in range(8)]
    stream.close()
    assert second["start_seq_index"] == first["next_seq_index"] == 24
    want = np.stack(batches[6:8])  # records 24..31 as two micro-batches
    np.testing.assert_array_equal(second["first_batch"].numpy(), want)
    np.testing.assert_array_equal(first["first_batch"].numpy(),
                                  np.stack(batches[:2]))


@pytest.mark.parametrize("case", ["toml_float32", "mixed_precision",
                                  "toml_without_dtype"])
def test_dtype_rule(tmp_path, case):
    toml = TOML if case != "toml_without_dtype" else \
        TOML.replace('dtype = "float32"\n', "")
    root = make_workspace(tmp_path / "ws", toml)
    extra = ["--mixed_precision"] if case == "mixed_precision" else []
    res = ttrain.run(train_args(root, "ck", "--num_steps", "1", *extra))
    want = "bfloat16" if case == "mixed_precision" else "float32"
    assert res["config"].dtype == want
    assert ProGenConfig().dtype == "bfloat16"  # the port's own default
    # a resume without the flag keeps the checkpoint's dtype
    again = ttrain.run(train_args(root, "ck", "--num_steps", "1"))
    assert again["config"].dtype == want


def test_cosine_and_shuffle_seed_survive_a_flagless_resume(ws):
    first = ttrain.run(train_args(
        ws, "ck_cos", "--num_steps", "2", "--lr_schedule", "cosine",
        "--warmup_steps", "1", "--shuffle_seed", "5", "--epochs", "2"))
    opt = first["state"].optimizer.config
    # 48 records x 2 epochs / 8 a step = 12, capped by --num_steps 2
    assert (opt.schedule, opt.warmup_steps, opt.total_steps) == \
        ("cosine", 1, 2)
    second = ttrain.run(train_args(ws, "ck_cos", "--num_steps", "1"))
    assert second["state"].optimizer.config == opt
    _, iter_fn = iterator_from_tfrecords_folder(str(ws / "train_data"))
    stream = iter_fn(32, 4, skip=16, loop=True, shuffle_seed=5)
    want = np.stack([next(stream) for _ in range(2)])
    stream.close()
    np.testing.assert_array_equal(second["first_batch"].numpy(), want)
    meta = get_checkpoint_fns(str(ws / "ck_cos"))[1].peek()
    assert meta.train_config == {"lr_schedule": "cosine", "warmup_steps": 1,
                                 "total_steps": 2, "shuffle_seed": 5}


@pytest.mark.parametrize("answer", ["y", "n"])
def test_new_asks_then_resets(ws, monkeypatch, answer):
    ckpt = f"ck_new_{answer}"
    ttrain.run(train_args(ws, ckpt, "--num_steps", "2"))
    monkeypatch.setattr(sys, "stdin", io.StringIO(answer + "\n"))
    res = ttrain.run(train_args(ws, ckpt, "--num_steps", "1", "--new"))
    if answer == "y":
        assert res["start_seq_index"] == 0 and res["state"].step == 1
    else:
        assert res == {"aborted": True}
        assert get_checkpoint_fns(str(ws / ckpt))[1].peek() \
            .next_seq_index == 16


@pytest.mark.parametrize("flag", [
    ["--hardware_rng"], ["--mesh", "2"],
], ids=lambda f: f[0])
def test_unported_flag_is_rejected(ws, capsys, flag):
    with pytest.raises(SystemExit) as exc:
        ttrain.run(train_args(ws, "ck_flag", *flag))
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err
    assert not (ws / "ck_flag").exists()


@pytest.mark.parametrize("argv,attr,want", [
    (["--flight_dir", "f"], "flight_dir", "f"),
    (["--profile_pin", "p"], "profile_pin_path", "p"),
], ids=lambda a: a[0] if isinstance(a, list) else None)
def test_forensics_flag_is_accepted(argv, attr, want):
    assert getattr(ttrain.parse_args(argv), attr) == want


@pytest.mark.parametrize("cli", ["train", "eval", "sample"])
def test_the_card_is_the_default(ws, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"train": train_args(ws, "ck_card")[2:],  # no --device cpu
            "eval": ["--checkpoint_path", str(ws / "ck_card")],
            "sample": ["--checkpoint_path", str(ws / "ck_card")]}[cli]
    mod = {"train": ttrain, "eval": teval, "sample": tsample}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(args)


def test_sigterm_saves_and_exits_zero(ws, tmp_path):
    """The first SIGTERM finishes the step, saves a checkpoint whose
    cursor counts the steps taken, and exits 0."""
    args = train_args(ws, "ck_term", "--epochs", "100000")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    with (tmp_path / "stderr").open("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "progen_tpu_torch.cli.train", *args],
            cwd=ws, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        watchdog = threading.Timer(240, proc.kill)  # a hang fails the test
        watchdog.start()
        try:
            out = ""
            for line in proc.stdout:  # one reader: no line is lost
                out += line
                if "] loss:" in line:
                    break
            proc.send_signal(signal.SIGTERM)
            out += proc.stdout.read()
            proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        err.seek(0)
        assert proc.returncode == 0, err.read()
    assert "finishing step, then checkpoint+exit" in out
    steps = sum("] loss:" in ln for ln in out.splitlines())
    assert steps >= 1
    meta = get_checkpoint_fns(str(ws / "ck_term"))[1].peek()
    assert meta.next_seq_index == 8 * steps


def test_eval_and_sample_from_the_checkpoint(ws, capsys):
    ttrain.run(train_args(ws, "ck_use", "--num_steps", "2"))
    ckpt = ["--checkpoint_path", str(ws / "ck_use")]
    res = teval.run(["--device", "cpu", "--batch_size", "5",
                     "--data_path", str(ws / "train_data"), *ckpt])
    assert res["sequences"] == 12 and res["batches"] == 3
    assert np.isfinite(res["loss"])
    assert res["perplexity"] == pytest.approx(np.exp(res["loss"]))
    out = capsys.readouterr().out
    assert "valid sequences: 12" in out and "perplexity:" in out

    got = tsample.run(["--device", "cpu", "--seed", "9", "--prime",
                       "[tax=Homo", *ckpt])
    pkg = get_checkpoint_fns(str(ws / "ck_use"))[1].restore_params()
    model = ProGen(ProGenConfig.from_dict(pkg.model_config), device="cpu",
                   seed=None)
    model.load_state_dict(pkg.state)
    from progen_tpu_torch.data.tokenizer import encode_tokens

    want = sample_fast(9, model, encode_tokens("[tax=Homo"), 32, top_k=25,
                       add_bos=True, device="cpu")
    assert torch.equal(got["tokens"], want)
    assert "trained for 16 sequences" in capsys.readouterr().out
    batched = tsample.run(["--device", "cpu", "--num_samples", "3",
                           "--naive", *ckpt])
    assert batched["tokens"].shape == (3, 32) and len(batched["texts"]) == 3


def test_naive_sampler_gives_sample_fasts_tokens():
    cfg = ProGenConfig(num_tokens=32, dim=32, seq_len=32, depth=3,
                       window_size=8, global_mlp_depth=1, heads=2,
                       dim_head=16, ff_mult=2, dtype="float32")
    model = ProGen(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    table = -np.log(-np.log(rng.uniform(size=(32, 3, 32)) + 1e-20) + 1e-20)

    def noise(t):
        return table[t, 0]

    prime = np.array([5, 9, 2])
    for top_k in (25, None):
        fast = sample_fast(0, model, prime, 30, top_k=top_k, add_bos=True,
                           device="cpu", noise=noise)
        naive = sample(0, model, prime, 30, top_k=top_k, add_bos=True,
                       device="cpu", noise=noise)
        assert torch.equal(naive, fast)
    primes = np.array([[5, 9], [7, 1], [3, 3]])
    fast = sample_fast_batched(0, model, primes, 32, add_bos=True,
                               device="cpu", noise=lambda t: table[t])
    naive = sample_batched(0, model, primes, 32, add_bos=True,
                           device="cpu", noise=lambda t: table[t])
    assert torch.equal(naive, fast)
    # the seeded draws: the same rule, so the same tokens
    assert torch.equal(
        sample_batched(4, model, primes, 32, device="cpu", top_k=5),
        sample_fast_batched(4, model, primes, 32, device="cpu", top_k=5))


def test_tracker_without_wandb(tmp_path, monkeypatch):
    import json

    from progen_tpu.tracking import render_sample_html as jax_render
    from progen_tpu_torch import tracking

    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    assert tracking.is_coordinator()
    assert type(tracking.make_tracker("p", disabled=True)) is \
        tracking.NoopTracker
    tr = tracking.make_tracker("proj", "run1", dir=str(tmp_path))
    assert isinstance(tr, tracking.JsonlTracker) and tr.run_id == "run1"
    tr.set_config({"dim": 32})
    tr.log({"loss": 1.5}, step=3)
    html = tracking.render_sample_html("[tax=Homo] #", "MKV")
    assert html == jax_render("[tax=Homo] #", "MKV")
    tr.log_html("samples", html, step=3)
    tr.finish()
    run = tmp_path / "proj" / "run1"
    rec = json.loads((run / "metrics.jsonl").read_text())
    assert (rec["loss"], rec["_step"]) == (1.5, 3)
    assert json.loads((run / "config.json").read_text()) == {"dim": 32}
    assert (run / "samples_3.html").read_text() == html
    with pytest.raises(ValueError, match="finished"):
        tr.log({"loss": 1.0})
