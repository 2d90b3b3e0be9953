"""Batch scoring CLI: bulk perplexity ranking of candidate sequences, the
JAX package's ``cli/batch_score.py``.

Streams a FASTA file or a TFRecord split through the training data
path, scores every sequence with the shared ``sequence_scores``
reduction (``workloads/scoring.py``), and writes sharded JSONL
(per-sequence NLL and perplexity, optional per-token logprobs) plus a
progress journal. Killed mid-run, a run with ``--resume`` (the default)
skips every durably written id and scores the rest: no duplicates, no
lost work. The summary is printed as one JSON line. The journal's
records also go to ``runs/progen-batch-score/<id>/events.jsonl`` under
the working directory. ``PROGEN_CHAOS`` arms the fault-injection sites
(``score/batch:kill@N`` kills the process after its Nth durable batch).
``--prom_file`` writes the scorer's Prometheus exposition (prefix
``progen_score_``), every ``--metrics-every`` batches and at the end.

Run: python -m progen_tpu_torch.cli.batch_score --checkpoint_path ./ckpts \\
         --input candidates.fasta --out_dir ./scores
"""

from __future__ import annotations

import argparse
import json
import os

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.cli.eval import load_model
from progen_tpu_torch.resilience.chaos import install_from_env
from progen_tpu_torch.telemetry import MetricsRegistry, spans
from progen_tpu_torch.tracking import JsonlTracker
from progen_tpu_torch.workloads.scoring import (
    fasta_records,
    run_batch_score,
    tfrecord_records,
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="progen_tpu_torch.cli.batch_score", allow_abbrev=False,
        description="Score candidate sequences into sharded JSONL.")
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--input", dest="input_path", required=True,
                   help="a FASTA file, or a TFRecord folder (see --split)")
    p.add_argument("--split", default="valid", choices=("train", "valid"),
                   help="which TFRecord split to score when --input is a "
                        "folder")
    p.add_argument("--context", default="",
                   help="conditioning tag prepended to every FASTA sequence "
                        "(scored as 'context # SEQ', the annotation "
                        "grammar)")
    p.add_argument("--out_dir", default="./scores",
                   help="output dir: scores-*.jsonl shards + score journal")
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--shard_size", default=512, type=int,
                   help="output lines per shard before rotating")
    p.add_argument("--logprobs", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="include per-token logprobs in each output record")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="skip ids already in the output shards (torn tails "
                        "from a kill are cut off first)")
    p.add_argument("--max_batches", default=None, type=int,
                   help="stop after N scored batches (a deterministic "
                        "partial run)")
    p.add_argument("--prom_file", default=None,
                   help="write Prometheus text exposition of the scoring "
                        "metrics here (atomic; on the --metrics-every "
                        "cadence and at the end)")
    p.add_argument("--metrics-every", dest="metrics_every", default=0,
                   type=int,
                   help="rewrite --prom_file every N batches (0 = at end "
                        "only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(argv=None) -> dict:
    """Score; returns the summary that is printed."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    install_from_env()
    model, _ = load_model(args.checkpoint_path, dev)
    if os.path.isdir(args.input_path):
        records = tfrecord_records(args.input_path, args.split)
    else:
        records = fasta_records(args.input_path, args.context)
    # a local run directory, never wandb: a batch job must not block on a
    # login or reach for the network
    tracker = JsonlTracker("progen-batch-score", None, "./runs")
    events = spans.EventLog(tracker.path / "events.jsonl")
    spans.configure(sink=events.emit)
    try:
        summary = run_batch_score(
            model, records, args.out_dir, batch_size=args.batch_size,
            logprobs=args.logprobs, shard_size=args.shard_size,
            resume=args.resume, metrics=MetricsRegistry(),
            prom_file=args.prom_file, metrics_every=args.metrics_every,
            max_batches=args.max_batches)
    finally:
        spans.configure()  # detach before the sink closes
        events.close()
        tracker.finish()
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
