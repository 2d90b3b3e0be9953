"""Library scoring: the program's ``run_batch_score`` ranking a stream of
candidate proteins by perplexity, as ``cli.batch_score`` runs it. The
model is the program's ``ProGen``; its sizes, seeded weights, kernels'
work and reference are the configuration's family's (``families/``).

Set-up loads the benchmark's seeded weights into the program's model
and scores ``warmup_batches`` batches of the cell's own shape into a
directory it then removes. The window hands ``run_batch_score`` one
record stream that ends, at a batch boundary, once ``--seconds`` have
passed; the rate is the sequences scored and durably written (flushed
and fsynced shard lines) over the whole call. The shards go to a fresh
directory under ``TMPDIR`` and are removed when the run has read them.

Correctness: once the window has closed and the model is freed, a
sample of the written sequences drawn from the seed, with the longest
among them, is scored again by the plain float32 reference from the
same weights and the same bytes; the widest gap of a written
per-sequence loss is the number compared. With ``--trace 1``, after the
window, a second ``run_batch_score`` call on the same stream scores the
batches of the profiler's two sessions (``trace.py``), each tracing
``profile_batches`` batches (the cell's file); that call is outside the
window and its rate.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import compare, proteins, spec as specs
from portbench.harness import Outcome, Readings, release
from portbench.reference import fp8, no_tf32
from portbench.trace import traced

WARMUP_PREFIX = "W"


def _stream(ctx, prefix: str = "P", salt: int = 0):
    p = ctx.cell.params
    return proteins.Proteins([ctx.seed, salt], p, int(p["batch_size"]),
                             prefix=prefix)


def _record(stream) -> tuple:
    """The next record as ``fasta_records`` gives it: the scored string
    is ``# SEQ``."""
    rid, seq = stream.next()
    return rid, b"# " + seq


def written_scores(out_dir: Path) -> dict:
    """id -> per-sequence loss of every line of the output shards."""
    out = {}
    for path in sorted(Path(out_dir).glob("scores-*.jsonl")):
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            out[rec["id"]] = float(rec["nll"])
    return out


def sample_ids(ctx, records: dict, ids) -> list:
    """``check_sequences`` of ``ids`` drawn from the seed, the longest
    first."""
    ids = sorted(ids)
    k = min(int(ctx.cell.params["check_sequences"]), len(ids))
    if k == 0:
        return []
    longest = max(ids, key=lambda i: (len(records[i]), i))
    rest = [i for i in ids if i != longest]
    rng = np.random.default_rng([ctx.seed, 2])
    picked = rng.choice(len(rest), size=k - 1, replace=False) if k > 1 \
        else []
    return [longest] + [rest[j] for j in sorted(picked)]


def reference_scores(ctx, records: dict, ids: list, linear=None) -> dict:
    """id -> the plain float32 reference's per-sequence loss."""
    cell = ctx.cell
    spec = cell.spec
    rows = int(cell.settings["reference_rows"])
    params = cell.weights(ctx.seed, ctx.device)
    out = {}
    with torch.no_grad(), no_tf32():
        for i in range(0, len(ids), rows):
            block = ids[i:i + rows]
            tokens = torch.from_numpy(proteins.encode_rows(
                [records[r] for r in block], spec.seq_len + 1)).to(ctx.device)
            nll = cell.family.rows_nll(
                params, spec, tokens, **({"linear": linear} if linear else {}))
            out.update(zip(block, nll.double().tolist()))
    return out


def _model(ctx):
    from progen_tpu_torch.config import ProGenConfig
    from progen_tpu_torch.models.progen import ProGen

    config = ProGenConfig.from_dict(specs.program_dict(ctx.cell.raw_config))
    with torch.device(ctx.device):
        model = ProGen(config, device=ctx.device, seed=None)
    model.load_state_dict(ctx.cell.weights(ctx.seed, ctx.device))
    ctx.mark("weights")
    return model


def _score(model, records, out_dir, p, **kwargs) -> dict:
    from progen_tpu_torch.workloads.scoring import run_batch_score

    return run_batch_score(model, records, str(out_dir),
                           batch_size=p["batch_size"],
                           logprobs=p["logprobs"], resume=False, **kwargs)


def _control(ctx) -> Outcome:
    """The reference in 8-bit products in the program's place, over as
    many records as the check compares."""
    stream = _stream(ctx)
    n = 4 * int(ctx.cell.params["check_sequences"])
    records = dict(_record(stream) for _ in range(n))
    ids = sample_ids(ctx, records, records)
    got = reference_scores(ctx, records, ids, linear=fp8.linear)
    want = reference_scores(ctx, records, ids)
    numbers = compare.score_numbers(got, want)
    numbers["lines_missing"] = 0.0
    return Outcome(attempted=0, failed=0, rates={}, numbers=numbers,
                   memory_peak_bytes=0)


def run(ctx) -> Outcome:
    if ctx.variant == "control":
        return _control(ctx)
    p = ctx.cell.params
    batch = int(p["batch_size"])
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    work = Path(tempfile.mkdtemp(prefix="portbench-score-"))
    try:
        model = _model(ctx)
        warm = _stream(ctx, WARMUP_PREFIX, salt=1)
        _score(model, (_record(warm) for _ in range(
            batch * int(p["warmup_batches"]))), work / "warmup", p)
        shutil.rmtree(work / "warmup")
        ctx.mark("warmup")

        stream = _stream(ctx)
        records = {}
        tokens = [0]

        def feed():
            k = 0
            while k % batch or time.perf_counter() < deadline:
                rid, raw = _record(stream)
                records[rid] = raw
                tokens[0] += proteins.row_tokens([raw])
                yield rid, raw
                k += 1

        from progen_tpu_torch.ops import launches

        launches.reset_counts()
        ctx.window_opens()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        summary = _score(model, feed(), work / "out", p)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        elapsed = time.perf_counter() - t0
        counts = launches.launch_counts()
        trace_summary = None
        span = int(ctx.cell.settings["profile_batches"])
        t = time.perf_counter()
        if ctx.trace:
            def drive(sessions):
                def traced_feed():
                    for k in range(batch * sessions.total):
                        if k % batch == 0:  # the batches before are written
                            sessions.before(k // batch)
                        yield _record(stream)

                shutil.rmtree(work / "traced", ignore_errors=True)
                _score(model, traced_feed(), work / "traced", p)
                sessions.before(sessions.total)

            trace_summary = traced(ctx.device, span, drive,
                                   ctx.cell.family.KERNEL_NAMES)
        trace_s = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
        del model
        release()
        written = written_scores(work / "out")
        out_bytes = sum(f.stat().st_size for f in (work / "out").iterdir())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = summary["n_scored"]
    readings = Readings(
        cell=ctx.cell, spans={},
        values={"tokens_per_s": tokens[0] / elapsed,
                "traced_steps_window_s": (span * elapsed / summary["batches"]
                                          if ctx.trace else None),
                "host_s_per_batch": (summary["times"]["data"]
                                     + summary["times"]["write"])
                / max(summary["batches"], 1),
                "traced_passes": (dict(rows=batch, forwards=span,
                                       backwards=0) if ctx.trace else None),
                "device_name": (torch.cuda.get_device_name(ctx.device)
                                if ctx.device.type == "cuda" else "cpu")},
        trace=trace_summary)
    ids = sample_ids(ctx, records, written)
    numbers = compare.score_numbers(
        written, reference_scores(ctx, records, ids))
    numbers["lines_missing"] = float(n - len(written))
    return Outcome(
        attempted=len(records), failed=len(records) - n,
        rates={"score_seqs_per_s": n / elapsed}, numbers=numbers,
        memory_peak_bytes=peak, readings=readings,
        info={"batches": summary["batches"], "tokens": tokens[0],
              "window_s": elapsed, "times": summary["times"],
              "shard_bytes": out_bytes, "launches": counts,
              "trace_s": trace_s})
