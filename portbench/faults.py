"""Faults planted under the timed path, for the checks that ``correct``
comes out false: each is a context manager that patches the program
while it is active. ``calibrate.py`` reads them on the card, the tests
on the CPU.

* ``unchanged_state``: the optimizer's update does nothing, so a step
  returns its parameters and moments as they were;
* ``half_batch``: each micro-batch's loss is the mean over its first
  half of rows, the rest left out;
* ``half_scored``: the scorer scores the first half of each batch and
  writes the mean of their losses for the rest;
* ``shifted_answers``: the scorer writes each row's loss against the
  next row's id (an answer altered where it is produced).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def unchanged_state():
    from progen_tpu_torch.training import optimizer

    with mock.patch.object(optimizer.MaskedAdamW, "update",
                           lambda self, grads, norm=None: None):
        yield


@contextlib.contextmanager
def half_batch():
    from progen_tpu_torch.training import step

    real = step.batch_loss

    def first_half(model, data, grid=None):
        return real(model, data[: max(1, data.shape[0] // 2)], grid)

    with mock.patch.object(step, "batch_loss", first_half):
        yield


@contextlib.contextmanager
def half_scored():
    from progen_tpu_torch.workloads import scoring

    real = scoring.score_step

    def first_half(model, batch, *, device="cuda"):
        batch = torch.as_tensor(batch)
        half = max(1, batch.shape[0] // 2)
        nll, lp, mask = real(model, batch, device=device)
        nll = nll.clone()
        nll[half:] = nll[:half].mean()
        return nll, lp, mask

    with mock.patch.object(scoring, "score_step", first_half):
        yield


@contextlib.contextmanager
def shifted_answers():
    from progen_tpu_torch.workloads import scoring

    real = scoring.score_step

    def shifted(model, batch, *, device="cuda"):
        nll, lp, mask = real(model, batch, device=device)
        return nll.roll(-1, 0), lp, mask

    with mock.patch.object(scoring, "score_step", shifted):
        yield


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SCORE = {"half_scored": half_scored, "shifted_answers": shifted_answers}
BY_KIND = {"train_closed": TRAIN, "score_library": SCORE}
