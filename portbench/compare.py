"""The numbers that decide ``correct``, each beside its limit.

Training: each step's loss against the reference's (the widest absolute
gap, in nats); the norm of each tensor's first gradient as the optimizer
takes it, and of each tensor's change over the first steps, against the
reference's, taken by the worst tensor: the gap between the two norms
over the larger of the reference's norm of that tensor and of the
median tensor (some gradients are all but zero). Tensors whose first
reference gradient is under a thousandth of the median tensor's move by
round-off alone and are left out of the change.

Scoring: the widest absolute gap between a written per-sequence loss
and the reference's, over a sample of the written sequences.
"""

from __future__ import annotations

import statistics

QUIET_SHARE = 1e-3  # a tensor moved by round-off alone: see the module


def worst_leaf_gap(got: dict, want: dict, keep=None) -> tuple:
    """(gap, tensor name) of the worst tensor, by the module's rule."""
    names = [n for n in want if keep is None or n in keep]
    if set(got) != set(want):
        raise ValueError("the program's tensors differ from the "
                         "reference's")
    floor = statistics.median(want[n] for n in want)
    worst = (0.0, None)
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], floor, 1e-30)
        if gap > worst[0]:
            worst = (gap, n)
    return worst


def moving_leaves(ref_grads: dict) -> set:
    """The tensors whose first reference gradient is at least
    ``QUIET_SHARE`` of the median tensor's."""
    floor = statistics.median(ref_grads.values())
    return {n for n, g in ref_grads.items() if g >= QUIET_SHARE * floor}


def train_numbers(got: dict, want: dict) -> dict:
    """name -> value of the training numbers, from the readings of the
    program (``got``) and of the reference (``want``), each with
    ``losses``, ``grad_norms`` and ``change_norms``."""
    if len(got["losses"]) != len(want["losses"]):
        raise ValueError("the program and the reference ran different "
                         "numbers of steps")
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"],
                                               want["losses"]))
    grad_gap, grad_leaf = worst_leaf_gap(got["grad_norms"],
                                         want["grad_norms"])
    change_gap, change_leaf = worst_leaf_gap(
        got["change_norms"], want["change_norms"],
        keep=moving_leaves(want["grad_norms"]))
    first_loss_gap = abs(got["losses"][0] - want["losses"][0])
    return {"loss_gap": loss_gap, "first_loss_gap": first_loss_gap,
            "grad_gap": grad_gap,
            "change_gap": change_gap,
            "_worst": {"grad": grad_leaf, "change": change_leaf}}


def score_numbers(got: dict, want: dict) -> dict:
    """``got``, ``want``: id -> per-sequence loss over the same sample.
    A sampled id missing from ``got`` is a wrong answer."""
    gaps = [abs(got[i] - want[i]) if i in got else float("inf")
            for i in want]
    return {"nll_gap": max(gaps)}


def checks(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] of every limited number; a number without
    a limit is a fault of the cell's file."""
    out = []
    for name, limit in limits.items():
        if name not in numbers:
            raise KeyError(f"no number {name!r} to hold against its limit")
        out.append((name, float(numbers[name]), float(limit)))
    return out


def passed(rows: list) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(v <= lim for _, v, lim in rows)
