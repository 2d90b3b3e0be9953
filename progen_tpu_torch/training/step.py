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

The grid (``parallel.Grid``): every rank gets the whole global batch and
takes its data rows (``shard_batch``) and its positions of each row. A
model axis above 1 needs a model built on the grid (``init_train_state``
with the grid): each rank holds its tensor-parallel shards and the
replicated rest, and its loss reduces the vocab-parallel softmax over the
model group. After the accumulation and before the clip, the gradients
and the micro-batch losses are summed over the replica group (the ranks
holding the same shards) and divided by the data size: summed over seq
(each shard's loss is its share of a sequence's), averaged over data.
The replicated tensors' gradients, equal on every rank of a model group,
are averaged over it too (one all-reduce over the world), which keeps
their copies bit-equal where a card's arithmetic might round them apart.
``grad_norm`` sums the shards' squares over the model group and counts a
replicated tensor once; it and the finite gate are computed from the
same reduced values on every rank, so every rank takes the same decision
and the same update. ``zero1`` cuts the moments over the data group
(``parallel/partition.py``).

Each call opens the span tree ``step/run`` > ``step/h2d`` (a wait),
``step/forward`` and ``step/backward`` per micro-batch (attr
``micro``), ``step/grad_reduce`` (with a grid), ``step/grad_norm``,
``step/gate`` (the finite gate's read, a wait) and ``step/update``
(when the gate passes; ``step/clip``, ``step/adamw`` and
``step/zero1_gather`` inside, from the optimizer). They add no launch
or synchronise.
"""

from __future__ import annotations

from typing import Callable

import torch

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.parallel.collectives import all_reduce_, broadcast_
from progen_tpu_torch.parallel.groups import Grid, shard_batch
from progen_tpu_torch.parallel.partition import Zero1
from progen_tpu_torch.parallel.tensor import layout
from progen_tpu_torch.telemetry.spans import span
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
    tp = model.tp
    if grid is None or grid.seq == 1:
        return cross_entropy(model(ids, grid), labels, tp=tp).mean()
    rows = grid.seq_slice(ids.shape[-1])
    return shard_cross_entropy(model(ids[..., rows], grid), labels,
                               rows, tp=tp).mean()


def split_sharded(model, tensors: dict) -> tuple[list, list]:
    """(replicated, sharded): ``tensors`` (keyed like the parameters)
    split by the model's tensor-parallel layout; all of them replicated
    when the model has none."""
    if model.tp is None:
        return list(tensors.values()), []
    rep, sharded = [], []
    for name, t in tensors.items():
        (rep if layout(name, model.config) is None else sharded).append(t)
    return rep, sharded


def reduce_grads(model, grads: dict, losses: torch.Tensor,
                 grid: Grid) -> None:
    """In place: the gradients and losses summed over the replica group
    and divided by the data size; the replicated tensors' gradients
    averaged over the model group as well (see the module docstring)."""
    rep, sharded = split_sharded(model, grads)
    if grid.model == 1:
        all_reduce_(rep + [losses], grid.world_group, 1.0 / grid.data)
        return
    all_reduce_(sharded + [losses], grid.replica_group, 1.0 / grid.data)
    all_reduce_(rep, grid.world_group, 1.0 / (grid.data * grid.model))


def grid_norm(model, grads: dict, grid: Grid | None) -> torch.Tensor:
    """The global norm of ``grads``: shards summed over the model group,
    replicated tensors counted once."""
    rep, sharded = split_sharded(model, grads)
    if grid is None or grid.model == 1:
        return global_norm(rep)
    return global_norm(rep, sharded, grid.model_group)


def make_train_step(grid: Grid | None = None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  tuple[TrainState, dict]]:
    """Returns train_step(state, batch) -> (state, metrics), which updates
    ``state`` in place. ``batch``: (grad_accum, micro_batch, seq_len + 1)
    integer tokens, on any device; with a ``grid``, the global batch,
    the same on every rank, which every rank steps together."""

    def train_step(state: TrainState, batch: torch.Tensor):
        with span("step/run"):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: torch.Tensor):
        model, opt = state.model, state.optimizer
        with span("step/h2d", wait=True):
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
        for k, micro in enumerate(batch):
            with span("step/forward", micro=k):
                loss = batch_loss(model, micro, grid)
            with span("step/backward", micro=k):
                loss.backward()  # sums into .grad across micro-batches
            losses.append(loss.detach())
        losses = torch.stack(losses)
        if grid is not None:
            # summed over seq, averaged over data
            with span("step/grad_reduce"):
                reduce_grads(model, {n: p.grad for n, p in params.items()},
                             losses, grid)
        grads = {name: p.grad.div_(batch.shape[0])
                 for name, p in params.items()}
        with span("step/grad_norm"):
            grad_norm = grid_norm(model, grads, grid)
        with span("step/gate", wait=True):
            ok = bool(torch.isfinite(losses).all()
                      & torch.isfinite(grad_norm))
        if ok:
            with span("step/update"):
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


def make_eval_step(grid: Grid | None = None
                   ) -> Callable[[TrainState, torch.Tensor], torch.Tensor]:
    """eval_step(state, data (micro_batch, seq_len + 1)) -> scalar loss,
    forward only. With a ``grid``, ``data`` is the global micro-batch,
    the same on every rank, and every rank returns the grid's loss."""

    def eval_step(state: TrainState, data: torch.Tensor) -> torch.Tensor:
        model = state.model
        data = torch.as_tensor(data).to(model.device)
        with torch.no_grad():
            if grid is None:
                return batch_loss(model, data)
            loss = batch_loss(model, shard_batch(data, grid), grid)
            all_reduce_([loss], grid.replica_group, 1.0 / grid.data)
            return loss

    return eval_step


def init_train_state(config: ProGenConfig,
                     optimizer: OptimizerConfig | None = None, *,
                     seed: int | None = 0, device="cuda",
                     grid: Grid | None = None,
                     zero1: bool = False) -> TrainState:
    """A fresh state: the model's seeded init on ``device`` (the card
    unless the caller passes "cpu"; raises when there is none), zero
    moments, count 0, step 0; ``seed`` None leaves the parameters for a
    state dict to fill. ``optimizer`` defaults to ``OptimizerConfig()``:
    lr 2e-4, weight decay 1e-3, clip 0.5. With a ``grid``, every rank
    calls it: the model holds the rank's tensor-parallel shards, and
    each rank takes the parameters of the first rank of its replica
    group (one broadcast), so the replicas start equal. ``zero1`` cuts
    the moments over the grid's data group."""
    model = ProGen(config, device=device, seed=seed, grid=grid)
    if grid is not None and seed is not None:
        broadcast_(list(model.parameters()), grid.replica_group,
                   src=grid.rank_of(0, 0, grid.model_index))
    opt = MaskedAdamW(model, optimizer or OptimizerConfig(),
                      Zero1.of(grid) if zero1 else None)
    return TrainState(step=0, model=model, optimizer=opt)
