"""The port's workload CLIs on the CPU (``cli.batch_score``, ``cli.scan``,
``cli.sample --template``, ``cli.convert``, ``cli.serve --int8``), on a
tiny checkpoint saved by the port's ``checkpoint.py`` (vocab 256, dim
32, seq_len 32, depth 2, window 8, one gMLP layer, float32, seeded
random weights).

Child processes only where a test needs one: the batch scorer SIGKILLed
by ``PROGEN_CHAOS=score/batch:kill@2`` and resumed (two children), and
``cli.serve --int8`` over stdin (one). The other CLIs run in this
process through ``run(argv)``. Held: every FASTA id scored exactly once
over the killed and the resumed run, each record bit-equal to the
in-process scorer's; the scan's JSON equal to ``mutagenesis_scan``; the
infill's frozen characters verbatim and its tokens ``sample_fast``'s;
the converted checkpoint's parameters the reference's; the int8
server's streams ``sample_fast``'s on the dequantised weights; the
card as the default device.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.cli import batch_score, convert, sample, scan, serve
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.convert import state_dict_to_flax_params
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.ops.quant import dequantize_tree, quantize_tree
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.training.step import init_train_state
from progen_tpu_torch.workloads import (
    AA_ALPHABET,
    fasta_records,
    infill_request_arrays,
    mutagenesis_scan,
    parse_template,
    run_batch_score,
)
from test_torch_workloads import haiku_params

REPO = Path(__file__).resolve().parents[1]
TINY = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
N_SEQS = 12


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(checkpoint directory, the model restored from it, a FASTA of
    N_SEQS candidates with Uniref50-style headers)."""
    root = tmp_path_factory.mktemp("torch_workloads_cli")
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
    rng = np.random.default_rng(4)
    fasta = root / "cands.fasta"
    fasta.write_text("".join(
        f">UniRef50_C{i} candidate n=1 Tax=Homo sapiens TaxID=9606\n"
        f"{''.join(rng.choice(list(AA_ALPHABET), int(rng.integers(8, 24))))}"
        "\n" for i in range(N_SEQS)))
    return root / "ck", model, fasta


def _records(out_dir: Path) -> list:
    """Every whole line of every shard (a torn tail is skipped)."""
    out = []
    for shard in sorted(out_dir.glob("scores-*.jsonl")):
        for line in shard.read_bytes().split(b"\n"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def test_batch_score_sigkill_then_resume(ckpt, tmp_path):
    ck, model, fasta = ckpt
    out_dir = tmp_path / "scores"

    def run(chaos: str):
        env = dict(os.environ, PROGEN_CHAOS=chaos, PYTHONPATH=str(REPO))
        return subprocess.run(
            [sys.executable, "-m", "progen_tpu_torch.cli.batch_score",
             "--device", "cpu", "--checkpoint_path", str(ck), "--input",
             str(fasta), "--out_dir", str(out_dir), "--batch_size", "4"],
            env=env, capture_output=True, text=True, timeout=300,
            cwd=tmp_path)

    killed = run("score/batch:kill@2")
    assert killed.returncode == -9, killed.stderr[-2000:]
    assert len(_records(out_dir)) == 8  # two durable batches, then death
    done = run("")
    assert done.returncode == 0, done.stderr[-2000:]
    summary = json.loads(done.stdout.strip().splitlines()[-1])
    assert (summary["n_resumed"], summary["n_scored"]) == (8, 4)
    got = _records(out_dir)
    ids = [r["id"] for r in got]
    assert sorted(ids) == sorted(f"UniRef50_C{i}" for i in range(N_SEQS))
    assert len(ids) == len(set(ids))
    assert sorted(p.name for p in out_dir.glob("scores-*.jsonl")) == \
        ["scores-00000.jsonl", "scores-00001.jsonl"]
    ops = [json.loads(ln)["op"] for ln in
           (out_dir / "score_journal.jsonl").read_text().splitlines()]
    assert ops == ["start", "batch", "batch", "resume", "batch", "done"]
    # the same weights and batch members: every record bit-equal to one
    # uninterrupted in-process run
    want = {r["id"]: r for r in _records_of_run(model, fasta, tmp_path)}
    for rec in got:
        assert rec == want[rec["id"]]


def _records_of_run(model, fasta, tmp_path) -> list:
    out = tmp_path / "whole"
    run_batch_score(model, fasta_records(str(fasta)), str(out),
                    batch_size=4)
    return _records(out)


def test_batch_score_in_process(ckpt, tmp_path, monkeypatch, capsys):
    ck, _, fasta = ckpt
    monkeypatch.chdir(tmp_path)
    summary = batch_score.run(
        ["--device", "cpu", "--checkpoint_path", str(ck), "--input",
         str(fasta), "--out_dir", "out", "--batch_size", "5",
         "--shard_size", "4", "--no-logprobs", "--context", "[x]",
         "--max_batches", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    assert summary["n_scored"] == 10 and summary["stopped_early"]
    recs = _records(tmp_path / "out")
    assert len(recs) == 10 and "logprobs" not in recs[0]
    assert len(list((tmp_path / "out").glob("scores-*.jsonl"))) == 3
    (events,) = (tmp_path / "runs" / "progen-batch-score").glob(
        "*/events.jsonl")
    lines = [json.loads(ln) for ln in events.read_text().splitlines()]
    assert [r["op"] for r in lines if r["ev"] == "score"] == [
        "start", "batch", "batch", "done"]
    # beside the scorer's spans
    assert {r["span"] for r in lines if r["ev"] == "B"} == {
        "score/run", "score/flush", "score/collate", "score/forward",
        "score/fetch", "score/write"}


def test_batch_score_reads_a_tfrecord_split(ckpt, tmp_path, monkeypatch):
    from progen_tpu_torch.data.tfrecord import tfrecord_writer

    ck, _, _ = ckpt
    data = tmp_path / "data"
    data.mkdir()
    with tfrecord_writer(str(data / "0.3.valid.tfrecord.gz")) as write:
        for s in (b"# MKTAYIAK", b"[tax=Homo] # GIVEQ", b"# MSKGEE"):
            write(s)
    monkeypatch.chdir(tmp_path)
    summary = batch_score.run(["--device", "cpu", "--checkpoint_path",
                               str(ck), "--input", str(data)])
    assert summary["n_scored"] == 3
    assert sorted(r["id"] for r in _records(tmp_path / "scores")) == \
        ["r0", "r1", "r2"]


def test_batch_score_prom_file(ckpt, tmp_path, monkeypatch):
    """--prom_file and --metrics-every: the scorer's counters and rates as
    Prometheus text under progen_score_, written at the end."""
    ck, _, fasta = ckpt
    monkeypatch.chdir(tmp_path)
    prom = tmp_path / "score.prom"
    summary = batch_score.run(
        ["--device", "cpu", "--checkpoint_path", str(ck), "--input",
         str(fasta), "--batch_size", "5", "--max_batches", "2",
         "--prom_file", str(prom), "--metrics-every", "1"])
    text = prom.read_text()
    assert f"progen_score_sequences_scored_total {summary['n_scored']}" \
        in text
    assert "progen_score_batches_total 2" in text
    for gauge in ("seq_per_s", "tokens_per_s", "goodput_pct"):
        assert f"# TYPE progen_score_{gauge} gauge" in text


def test_scan_writes_its_report(ckpt, tmp_path, capsys):
    ck, model, _ = ckpt
    out = tmp_path / "scan.json"
    report = scan.run(["--device", "cpu", "--checkpoint_path", str(ck),
                       "--sequence", "MKTAYIAKQR", "--positions", "2:8",
                       "--top", "8", "--out", str(out), "--chunk", "16"])
    doc = json.loads(out.read_text())
    assert np.asarray(doc["nll"]).shape == (6, 20)
    assert doc["positions"] == [2, 3, 4, 5, 6, 7] and len(doc["top"]) == 8
    want = mutagenesis_scan(model, "MKTAYIAKQR", positions=range(2, 8),
                            top=8)
    np.testing.assert_array_equal(np.asarray(doc["nll"], np.float32),
                                  want["nll"])
    assert doc["wt_nll"] == want["wt_nll"] == report["wt_nll"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("wild-type NLL: ") and \
        "(6 positions x 20 substitutions)" in lines[0]
    assert lines[1] == f"{'pos':>5} {'wt':>3} {'mut':>4} {'nll':>9} " \
        f"{'delta_nll':>10}"
    top = want["top"][0]
    assert lines[2] == (f"{top['pos']:>5} {top['wt']:>3} {top['aa']:>4} "
                        f"{top['nll']:>9.4f} {top['delta_nll']:>+10.4f}")
    assert lines[-1] == f"report written to {out}"


def test_scan_takes_a_fasta_record(ckpt, tmp_path):
    ck, model, fasta = ckpt
    report = scan.run(["--device", "cpu", "--checkpoint_path", str(ck),
                       "--fasta", str(fasta), "--index", "3",
                       "--positions", "0,2", "--context", "[x]"])
    seq = list(fasta_records(str(fasta)))[3][1].decode()[2:]
    assert report["sequence"] == seq and report["positions"] == [0, 2]
    for argv in (["--sequence", "MK", "--fasta", str(fasta)], [],
                 ["--fasta", str(fasta), "--index", str(N_SEQS)]):
        with pytest.raises(SystemExit):
            scan.run(["--device", "cpu", "--checkpoint_path", str(ck),
                      *argv])


def test_sample_template_keeps_the_frozen_characters(ckpt, capsys):
    ck, model, _ = ckpt
    template = "MK?LV??GA?"
    got = sample.run(["--device", "cpu", "--checkpoint_path", str(ck),
                      "--template", template, "--seed", "3"])
    toks, frz = parse_template(template)
    prime, length, tpl, frozen = infill_request_arrays(toks, frz)
    want = sample_fast(3, model, prime, length, top_k=25, add_bos=True,
                       template=tpl, frozen=frozen, device="cpu")
    assert torch.equal(got["tokens"], want)
    row = got["tokens"].numpy()
    text = decode_tokens(row[1:])
    for i, c in enumerate(template):
        if c != "?" and i < len(text):
            assert text[i] == c
    assert (row[frozen] == tpl[frozen]).all()
    assert got["texts"] == [decode_tokens(row[len(prime) + 1:])]
    out = capsys.readouterr().out
    assert " MK " in out  # the frozen prefix is printed as the prime
    naive = sample.run(["--device", "cpu", "--checkpoint_path", str(ck),
                        "--template", "M?_K", "--free_char", "_",
                        "--naive", "--seed", "3"])
    assert naive["tokens"][4] == encode_tokens("K")[0]  # BOS, M, ?, _, K


@pytest.mark.parametrize("extra", [["--prime", "MK"],
                                   ["--num_samples", "2"]],
                         ids=["prime", "num_samples"])
def test_sample_template_refuses_its_exclusions(ckpt, extra):
    ck, _, _ = ckpt
    with pytest.raises(SystemExit, match="--template"):
        sample.run(["--device", "cpu", "--checkpoint_path", str(ck),
                    "--template", "MK?", *extra])


def test_convert_writes_a_checkpoint_that_loads(ckpt, tmp_path, capsys):
    _, model, _ = ckpt
    cfg = model.config
    tree = state_dict_to_flax_params(model.state_dict(), cfg)
    src = tmp_path / "ckpt_1690000000.pkl"
    src.write_bytes(pickle.dumps({
        "next_seq_index": 77, "params": haiku_params(tree, cfg.depth),
        "optim_state": None, "model_config": cfg.to_dict(),
        "run_id": "ref"}))
    written = convert.run(["--device", "cpu", "--src", str(src), "--dest",
                           str(tmp_path / "native")])
    assert capsys.readouterr().out.strip() == \
        f"converted {src} -> {written}"
    loaded, pkg = load_model(str(tmp_path / "native"), torch.device("cpu"))
    assert (pkg.next_seq_index, pkg.run_id, pkg.path) == (77, "ref",
                                                          written)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_serve_int8_over_stdin(ckpt, tmp_path):
    ck, model, _ = ckpt
    reqs = [{"id": "a", "prime": "MKV", "length": 24, "seed": 3},
            {"id": "t", "template": "MK?LVG?A??", "seed": 5}]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.cli.serve", "--device",
         "cpu", "--checkpoint_path", str(ck), "--max-len", "32", "--int8"],
        input="".join(json.dumps(r) + "\n" for r in reqs),
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    (line,) = [ln for ln in res.stderr.splitlines()
               if ln.startswith("int8 weights: ")]
    q, scales, report = quantize_tree(model.state_dict(), model.config)
    nbytes_fp = sum(r["bytes_fp"] for r in report)
    nbytes_q = sum(r["bytes_int8"] for r in report)
    assert line.startswith(f"int8 weights: {len(report)} kernels, "
                           f"{nbytes_fp} -> {nbytes_q} bytes, calib logits "
                           "max-abs-err ")
    deq = ProGen(model.config, device="cpu", seed=None)
    deq.load_state_dict(dequantize_tree(q, scales, torch.float32))
    events = [json.loads(ln) for ln in res.stdout.splitlines()]
    done = {ev["id"]: ev for ev in events if ev["event"] == "done"}
    assert sorted(done) == ["a", "t"]
    for r in reqs:
        kw = dict(top_k=25, add_bos=True, device="cpu")
        if "template" in r:
            toks, frz = parse_template(r["template"])
            prime, length, tpl, frozen = infill_request_arrays(toks, frz)
            kw.update(template=tpl, frozen=frozen)
        else:
            prime, length = encode_tokens(r["prime"]), r["length"]
        want = sample_fast(r["seed"], deq.eval(), prime, length, **kw)
        start = len(prime) + 1
        assert done[r["id"]]["text"] == decode_tokens(want.numpy()[start:])


def test_serve_parses_int8_both_ways():
    assert serve.parse_args(["--int8"]).quantize_int8
    assert not serve.parse_args(["--no-int8"]).quantize_int8
    assert not serve.parse_args([]).quantize_int8


@pytest.mark.parametrize("cli", ["batch_score", "scan", "convert",
                                 "sample_template"])
def test_the_card_is_the_default(ckpt, tmp_path, monkeypatch, cli):
    ck, _, fasta = ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, argv = {
        "batch_score": (batch_score, ["--checkpoint_path", str(ck),
                                      "--input", str(fasta), "--out_dir",
                                      str(tmp_path / "s")]),
        "scan": (scan, ["--checkpoint_path", str(ck), "--sequence", "MKV"]),
        "convert": (convert, ["--src", str(tmp_path / "none.pkl"),
                              "--dest", str(tmp_path / "d")]),
        "sample_template": (sample, ["--checkpoint_path", str(ck),
                                     "--template", "MK?"]),
    }[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(argv)
    assert not (tmp_path / "s").exists() and not (tmp_path / "d").exists()
