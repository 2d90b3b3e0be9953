"""Tiny cells for the CPU tests: the cells' own traffic kinds and
runners at a size the CPU runs in seconds, with limits read at that
size (the cells' own limits are read at theirs, on the card)."""

from __future__ import annotations

from pathlib import Path

import torch

from portbench import harness
from portbench.families import progen

CHECKOUT = Path(__file__).resolve().parents[2]
TINY = dict(num_tokens=256, dim=64, depth=2, heads=2, dim_head=16,
            window_size=32, seq_len=64, global_mlp_depth=1, ff_mult=4,
            ff_glu=True, shift_tokens=True, rotate_value=True,
            layer_norm_epsilon=1e-5, remat=True, dtype="bfloat16",
            param_dtype="float32")
CPU = torch.device("cpu")
# read on the CPU at this size over the seeds 2**31 + 5, 7, 11 and 12:
# the program's largest loss, grad and change gaps 0.0018, 0.0055 and
# 0.0112, its nll gap 0.0037; the control's smallest loss gap 0.0097,
# grad gap 0.020 and nll gap 0.025 (its change gap reads 0.012 on some
# seeds: the loss and grad gaps are the numbers that refuse it here)
TRAIN_LIMITS = dict(loss_gap=0.006, grad_gap=0.01, change_gap=0.015)
SCORE_LIMITS = dict(nll_gap=0.012, lines_missing=0)
SEEDS = (2**31 + 5, 7)


def bench() -> harness.Bench:
    return harness.Bench(CHECKOUT)


def cell(kind: str) -> harness.Cell:
    """A tiny cell of ``kind`` with the metrics of the real cells of
    that kind."""
    b = bench()
    like = "train-base-4x4" if kind == "train_closed" else "score-base-b32"
    real = b.cell(like)
    lengths = dict(length_median=30, length_sigma=0.62, min_residues=8,
                   residues=real.params["residues"],
                   residue_percent=real.params["residue_percent"])
    if kind == "train_closed":
        params = dict(lengths, grad_accum=2, micro_batch=2, max_residues=62,
                      first_steps=3)
        settings = dict(reference_rows=2, profile_steps=1,
                        limits=dict(TRAIN_LIMITS))
    else:
        params = dict(lengths, batch_size=4, logprobs=False, max_residues=61,
                      warmup_batches=1, check_sequences=6)
        settings = dict(reference_rows=4, profile_batches=1,
                        limits=dict(SCORE_LIMITS))
    return harness.Cell(
        name=f"tiny-{kind}", chips=1, config_name="tiny",
        traffic_name="tiny", kind=kind, raw_config=dict(TINY),
        family=progen, spec=progen.Spec.from_dict(TINY), params=params,
        settings=settings, end_to_end=real.end_to_end,
        per_layer=real.per_layer)


def execute(kind: str, seed: int, seconds: float = 0.5, trace=False,
            variant="program"):
    return harness.execute(bench(), cell(kind), seed, seconds, trace, CPU,
                           variant=variant)
