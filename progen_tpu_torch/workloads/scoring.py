"""Bulk perplexity scoring: FASTA/TFRecord candidates -> sharded JSONL.

The port of the JAX package's ``workloads/scoring.py``. The
protein-design ranking workload: stream candidate sequences through the
training data path (byte tokenizer + collate, so scores compare with the
training loss), batch them into power-of-two length buckets, and score
them with the shared ``sequence_scores`` reduction of
``training/loss.py``, the function ``cli/eval.py`` reduces too. On the
card each batch is one full forward through the kernels A1, L1 and L2.

Resume contract (the serving journal's discipline applied to batch
work): every flushed output shard line is durable; on restart the scorer
re-reads ``scores-*.jsonl`` (cutting off a torn last line that a kill
mid-write left), skips every id already written, and appends to a FRESH
shard. SIGKILL at any point, run again, and the union of the shards
holds every input id exactly once. The score journal
(``score_journal.jsonl``, ops start/resume/batch/skip/done) is the
progress record and also goes to the telemetry sink, but the OUTPUT
SHARDS decide what has been scored: a journal can claim a batch that the
kill beat to disk. The file names, record fields, journal ops and
summary keys are the JAX package's, so either package resumes the
other's output directory.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.data.dataset import _sort_key, collate
from progen_tpu_torch.resilience.chaos import maybe_inject
from progen_tpu_torch.telemetry.spans import get_telemetry
from progen_tpu_torch.telemetry.trace import iter_jsonl
from progen_tpu_torch.training.loss import sequence_scores

SCORE_OPS = ("start", "resume", "batch", "skip", "done")

_JOURNAL_NAME = "score_journal.jsonl"
_SHARD_FMT = "scores-%05d.jsonl"
_ITEM_6 = "ROADMAP queue 1 item 6 (the host-side stack)"


@torch.inference_mode()
def score_step(model, batch, *, device="cuda"):
    """(B, n+1) collated int batch (BOS column first) -> (per_seq_nll (B,),
    per_token_logprob (B, n), mask (B, n)). A model with gMLP layers is
    bound to its seq_len, so n must equal it there."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.asarray(batch))
    batch = batch.to(device=dev, dtype=torch.long)
    ids, labels = batch[..., :-1], batch[..., 1:]
    return sequence_scores(model(ids), labels)


def _host_scores(nll, lp, mask) -> Tuple[np.ndarray, ...]:
    """The three results of ``score_step`` on the host in one copy:
    packed into one float32 (B, 1 + 2n) tensor (the mask as 0/1, exact)
    and split again there."""
    n = lp.shape[-1]
    packed = torch.cat([nll[:, None], lp, mask.float()], dim=1).cpu().numpy()
    return packed[:, 0], packed[:, 1:1 + n], packed[:, 1 + n:] != 0


class _ScoreStep:
    """score_step + first-time-shape bookkeeping, so the time ledger can
    bill a bucket's first call to ``compile`` as the JAX scorer does. The
    port compiles nothing; a shape's first call is its first launch on the
    card (allocator growth, cuBLAS heuristics)."""

    def __init__(self, model):
        self.model = model
        self.seen_shapes = set()

    def __call__(self, batch):
        first = batch.shape not in self.seen_shapes
        self.seen_shapes.add(batch.shape)
        out = score_step(self.model, batch, device=self.model.device)
        return _host_scores(*out), first


class ScoreJournal:
    """Append-only progress journal, one JSON line per event, flushed
    before return; every record also goes to the telemetry sink, so an
    event file sees scoring progress beside everything else."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, _JOURNAL_NAME)
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        get_telemetry().emit(record)

    def close(self) -> None:
        self._f.close()


def fasta_records(path: str, context: str = "") -> Iterator[Tuple[str, bytes]]:
    """FASTA -> (id, training-string bytes). The id is the first word of
    the description (``seq{i}`` when there is none); the scored string
    follows the annotation grammar (``context # SEQ`` / ``# SEQ``), so
    conditioning tags score the way they train."""
    from progen_tpu_torch.data.fasta import parse_fasta

    prefix = f"{context} # " if context else "# "
    for i, (desc, seq) in enumerate(parse_fasta(path)):
        words = desc.split()
        rid = words[0] if words else f"seq{i}"
        yield rid, (prefix + seq).encode("utf-8")


def tfrecord_records(folder: str,
                     split: str = "valid") -> Iterator[Tuple[str, bytes]]:
    """TFRecord split -> (id, raw bytes): ids are ``r{global_index}`` in
    the shard-sorted order, so they are stable across runs (the resume
    contract needs ids that name the same record)."""
    from progen_tpu_torch.data.tfrecord import read_tfrecords

    pattern = os.path.join(folder, f"*.{split}.tfrecord.gz")
    files = sorted(glob.glob(pattern), key=_sort_key)
    if not files:
        raise FileNotFoundError(f"no {split} tfrecords under {folder}")
    gidx = 0
    for f in files:
        for rec in read_tfrecords(f):
            yield f"r{gidx}", rec
            gidx += 1


def scored_ids(out_dir: str) -> Tuple[set, int]:
    """(ids already durably scored, next shard index) from the output
    shards, the resume authority. A torn tail (a kill mid-write left a
    partial last line) is cut off before parsing; the resume then opens a
    FRESH shard rather than appending after bytes it cannot vouch for."""
    seen: set = set()
    next_idx = 0
    for path in sorted(glob.glob(os.path.join(out_dir, "scores-*.jsonl"))):
        base = os.path.basename(path)
        try:
            idx = int(base[len("scores-"):-len(".jsonl")])
        except ValueError:
            continue
        next_idx = max(next_idx, idx + 1)
        with open(path, "rb") as f:
            data = f.read()
        if data and not data.endswith(b"\n"):
            cut = data.rfind(b"\n")
            with open(path, "wb") as f:
                f.write(data[:cut + 1] if cut >= 0 else b"")
        for rec in iter_jsonl(path):
            if "id" in rec:
                seen.add(rec["id"])
    return seen, next_idx


class _ShardWriter:
    """Rotating JSONL shard writer; the lines are flushed and fsynced at
    batch granularity, so a batch on disk survives SIGKILL."""

    def __init__(self, out_dir: str, start_index: int, shard_size: int):
        self.out_dir = out_dir
        self.index = start_index
        self.shard_size = max(int(shard_size), 1)
        self.in_shard = 0
        self._f = None

    def _open(self):
        path = os.path.join(self.out_dir, _SHARD_FMT % self.index)
        self._f = open(path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        if self._f is None:
            self._open()
        self._f.write(json.dumps(record) + "\n")
        self.in_shard += 1
        if self.in_shard >= self.shard_size:
            self.flush()
            self._f.close()
            self._f = None
            self.index += 1
            self.in_shard = 0

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self.flush()
            self._f.close()
            self._f = None


def _bucket(n: int, seq_len: int, minimum: int, fixed: bool) -> int:
    """Power-of-two length bucket for a sequence of ``n`` tokens.
    ``fixed`` forces the full seq_len: a model with gMLP layers binds an
    (seq_len, seq_len) SGU matrix, so its full forward takes only
    seq_len-wide inputs; bucketing serves pure-attention models
    (global_mlp_depth == 0)."""
    if fixed:
        return seq_len
    b = max(int(minimum), 1)
    while b < n:
        b *= 2
    return min(b, seq_len)


def run_batch_score(
    model,
    records: Iterable[Tuple[str, bytes]],
    out_dir: str,
    *,
    batch_size: int = 8,
    logprobs: bool = True,
    shard_size: int = 512,
    resume: bool = True,
    metrics=None,
    prom_file: Optional[str] = None,
    metrics_every: int = 0,
    max_batches: Optional[int] = None,
    min_bucket: int = 32,
) -> dict:
    """Score a record stream with ``model`` (on its own device) into
    ``out_dir``: sharded JSONL and the journal.

    Records longer than the model's seq_len are skipped (journalled with
    op "skip": they cannot be scored with training semantics). A ragged
    final batch of a bucket is padded with empty rows whose results are
    dropped. ``max_batches`` stops after N scored batches (a
    deterministic partial run). ``metrics``, ``prom_file`` and
    ``metrics_every`` feed the Prometheus exposition, which is not ported
    yet: setting one raises.
    """
    if metrics is not None or prom_file or metrics_every:
        raise NotImplementedError(
            "the scorer's metrics registry and Prometheus file are not "
            f"ported yet: {_ITEM_6}")
    cfg = model.config
    seq_len = cfg.seq_len
    fixed_len = cfg.global_mlp_depth > 0  # see _bucket
    # local attention needs window-divisible widths; window sizes are
    # powers of two, so flooring the bucket keeps every pow2 bucket legal
    min_bucket = max(min_bucket, cfg.window_size)
    os.makedirs(out_dir, exist_ok=True)
    journal = ScoreJournal(out_dir)
    seen, shard_idx = scored_ids(out_dir) if resume else (set(), 0)
    writer = _ShardWriter(out_dir, shard_idx, shard_size)
    step_fn = _ScoreStep(model)

    times = {"data": 0.0, "step": 0.0, "compile": 0.0, "write": 0.0}
    stats = {"n_scored": 0, "n_skipped": 0, "n_resumed": len(seen),
             "tokens": 0, "batches": 0}
    journal.emit({"ev": "score", "op": "resume" if seen else "start",
                  "out_dir": out_dir, "already_scored": len(seen),
                  "shard_index": shard_idx})
    t0 = time.monotonic()
    stopped_early = False
    pending: dict = {}  # bucket -> list of (rid, raw bytes)

    def flush_bucket(bucket: int) -> None:
        batch = pending.pop(bucket, [])
        if not batch:
            return
        n = len(batch)
        rows = [raw for _, raw in batch]
        rows += [b""] * (batch_size - n)  # pad rows: all-zero, dropped
        t = time.monotonic()
        data = collate(rows, bucket)
        times["data"] += time.monotonic() - t

        t = time.monotonic()
        (nll, lp, mask), first = step_fn(data)
        dt = time.monotonic() - t
        times["compile" if first else "step"] += dt

        t = time.monotonic()
        for i, (rid, _) in enumerate(batch):
            rec = {"id": rid,
                   "seq_index": stats["n_resumed"] + stats["n_scored"],
                   "n_tokens": int(mask[i].sum()),
                   "nll": float(nll[i]),
                   "ppl": float(np.exp(nll[i]))}
            if logprobs:
                rec["logprobs"] = [float(x) for x in lp[i][mask[i]]]
            writer.write(rec)
            seen.add(rid)
            stats["n_scored"] += 1
            stats["tokens"] += rec["n_tokens"]
        writer.flush()
        times["write"] += time.monotonic() - t
        stats["batches"] += 1
        journal.emit({"ev": "score", "op": "batch", "bucket": bucket,
                      "n": n, "scored": stats["n_scored"],
                      "step_s": round(dt, 6)})
        # the kill site: SIGKILL lands AFTER the batch is durable (flushed
        # and fsynced above), so a resume re-scores nothing
        maybe_inject("score/batch")

    for rid, raw in records:
        if rid in seen:
            continue
        n_tok = len(raw) + 1  # + the EOS position the loss mask keeps
        if n_tok > seq_len:
            journal.emit({"ev": "score", "op": "skip", "id": str(rid),
                          "n_tokens": n_tok, "seq_len": seq_len})
            stats["n_skipped"] += 1
            continue
        b = _bucket(n_tok, seq_len, min_bucket, fixed_len)
        pending.setdefault(b, []).append((rid, raw))
        if len(pending[b]) >= batch_size:
            flush_bucket(b)
            if max_batches is not None and stats["batches"] >= max_batches:
                stopped_early = True
                break

    if not stopped_early:
        for b in sorted(pending):
            flush_bucket(b)
            if max_batches is not None and stats["batches"] >= max_batches:
                stopped_early = True
                break

    writer.close()
    elapsed = max(time.monotonic() - t0, 1e-9)
    summary = {
        "n_scored": stats["n_scored"],
        "n_skipped": stats["n_skipped"],
        "n_resumed": stats["n_resumed"],
        "tokens": stats["tokens"],
        "batches": stats["batches"],
        "elapsed_s": round(elapsed, 3),
        "goodput_pct": round(100.0 * times["step"] / elapsed, 2),
        "times": {k: round(v, 3) for k, v in times.items()},
        "stopped_early": stopped_early,
    }
    journal.emit({"ev": "score", "op": "done", **summary})
    journal.close()
    return summary
