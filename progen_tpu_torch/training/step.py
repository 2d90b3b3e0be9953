"""The train step: per-sequence EOS-masked cross entropy averaged over
the batch, gradient accumulation, global-norm clip, masked AdamW, and the
finite gate.

Counterpart of ``progen_tpu/training/step.py:54-118``, with its semantics:

* a batch is (grad_accum, micro_batch, seq_len + 1) tokens, shifted into
  ids and labels inside the step;
* gradients are averaged over the accumulation axis BEFORE they are
  clipped, and ``grad_norm`` is the norm of that average, unclipped;
* the finite gate: when any micro-batch loss or the grad norm is not
  finite, the parameters, the moments and the optimizer's count stay as
  they were, but ``state.step`` still advances (the batch was consumed);
* the metrics ``loss``, ``last_micro_loss``, ``grad_norm`` and
  ``skipped``.

The micro-batches run one after another and their gradients accumulate
in the parameters' ``.grad`` (JAX scans over them); the state is updated
in place (see ``state.py``).

Data and sequence parallelism (``parallel.Grid``): every rank holds the
whole parameters and gets the whole global batch; it takes its data rows
(``shard_batch``) and its positions of each row. After the accumulation
and before the clip, one bucketed all_reduce sums the gradients and the
micro-batch losses over the grid and divides them by the data size:
summed over seq (each shard's loss is its share of a sequence's), averaged
over data. ``grad_norm`` and the finite gate are then computed from the
same reduced values on every rank, so every rank takes the same decision
and the same update. No ZeRO-1: the optimizer state is replicated too.
"""

from __future__ import annotations

from typing import Callable

import torch

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.parallel.collectives import all_reduce_, broadcast_
from progen_tpu_torch.parallel.groups import Grid, shard_batch
from progen_tpu_torch.training.loss import cross_entropy, shard_cross_entropy
from progen_tpu_torch.training.optimizer import (
    MaskedAdamW,
    OptimizerConfig,
    global_norm,
)
from progen_tpu_torch.training.state import TrainState


def batch_loss(model: ProGen, data: torch.Tensor,
               grid: Grid | None = None) -> torch.Tensor:
    """data: (micro_batch, seq_len + 1) tokens. The mean over the batch of
    the per-sequence masked cross entropy. With a ``grid`` of seq size
    above 1, this rank's share of it: its positions of each (whole) row
    through the model, and ``shard_cross_entropy``."""
    ids, labels = data[..., :-1], data[..., 1:]
    if grid is None or grid.seq == 1:
        return cross_entropy(model(ids), labels).mean()
    rows = grid.seq_slice(ids.shape[-1])
    return shard_cross_entropy(model(ids[..., rows], grid), labels,
                               rows).mean()


def make_train_step(grid: Grid | None = None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  tuple[TrainState, dict]]:
    """Returns train_step(state, batch) -> (state, metrics), which updates
    ``state`` in place. ``batch``: (grad_accum, micro_batch, seq_len + 1)
    integer tokens, on any device; with a ``grid``, the global batch,
    the same on every rank, which every rank steps together."""

    def train_step(state: TrainState, batch: torch.Tensor):
        model, opt = state.model, state.optimizer
        batch = torch.as_tensor(batch).to(model.device)
        if batch.ndim != 3:
            raise ValueError("batch must be (grad_accum, micro_batch, "
                             f"seq_len + 1), got {tuple(batch.shape)}")
        if grid is not None:
            batch = shard_batch(batch, grid)
        params = opt.params
        for p in params.values():
            p.grad = None
        losses = []
        for micro in batch:
            loss = batch_loss(model, micro, grid)
            loss.backward()  # sums into .grad across micro-batches
            losses.append(loss.detach())
        losses = torch.stack(losses)
        if grid is not None:
            # summed over seq, averaged over data, in one collective
            all_reduce_([p.grad for p in params.values()] + [losses],
                        grid.world_group, 1.0 / grid.data)
        grads = {name: p.grad.div_(batch.shape[0])
                 for name, p in params.items()}
        grad_norm = global_norm(grads.values())
        ok = bool(torch.isfinite(losses).all() & torch.isfinite(grad_norm))
        if ok:
            opt.update(grads, grad_norm)
        for p in params.values():
            p.grad = None
        state.step += 1
        metrics = {
            "loss": losses.mean(),
            "last_micro_loss": losses[-1],
            "grad_norm": grad_norm,
            "skipped": torch.tensor(int(not ok), dtype=torch.int32),
        }
        return state, metrics

    return train_step


def make_eval_step() -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """eval_step(state, data (micro_batch, seq_len + 1)) -> scalar loss,
    forward only."""

    def eval_step(state: TrainState, data: torch.Tensor) -> torch.Tensor:
        model = state.model
        with torch.no_grad():
            return batch_loss(model, torch.as_tensor(data).to(model.device))

    return eval_step


def init_train_state(config: ProGenConfig,
                     optimizer: OptimizerConfig | None = None, *,
                     seed: int = 0, device="cuda",
                     grid: Grid | None = None) -> TrainState:
    """A fresh state: the model's seeded init on ``device`` (the card
    unless the caller passes "cpu"; raises when there is none), zero
    moments, count 0, step 0. ``optimizer`` defaults to
    ``OptimizerConfig()``: lr 2e-4, weight decay 1e-3, clip 0.5. With a
    ``grid``, every rank calls it and gets global rank 0's parameters
    (one broadcast), so the replicas start equal."""
    model = ProGen(config, device=device, seed=seed)
    if grid is not None:
        broadcast_(list(model.parameters()), grid.world_group, src=0)
    opt = MaskedAdamW(model, optimizer or OptimizerConfig())
    return TrainState(step=0, model=model, optimizer=opt)
