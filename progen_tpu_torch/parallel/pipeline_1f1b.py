"""The 1F1B (one-forward-one-backward) pipeline schedule.

Counterpart of ``progen_tpu/parallel/pipeline_1f1b.py:49-388``
(``pipeline_1f1b_loss_and_grads``, ``make_1f1b_train_step``), on the
stages of ``parallel/pipeline.py`` (``PipelineStage``, ``StageLinks``).

Schedule, in ticks of one forward slot and one backward slot a stage:

  stage p forwards  microbatch f = t - p               while 0 <= f < M
  stage p backwards microbatch b = t - 2 * (P - 1) + p while 0 <= b < M

over T = M + 2 (P - 1) ticks. After each tick every forward output hops
one stage right and every boundary gradient one stage left, each a
broadcast in the two-rank group of the neighbours that both sides
schedule alike. A forward slot runs without autograd and keeps only the
stage's boundary input, so a stage holds at most 2 (P - 1) of them
(stage 0 keeps none: it embeds again); the backward slot RECOMPUTES the
stage from that input and back-propagates the gradient that arrived
(with ``config.remat`` each block is recomputed once more inside it).
The last stage's f and b coincide: its loss head runs fused with its
forward, whose backward follows at once.

The step keeps this path's own semantics, as its JAX twin does, which
depart from the plain step (``training/step.py``):
  * the loss of a micro-step is the mean of its microbatch means (and of
    the data ranks'), the head fused on the last stage;
  * the gradients are averaged over the accumulation axis and handed to
    ``MaskedAdamW.update`` (clip, masked AdamW) with NO finite gate: a
    non-finite loss or norm is applied, not refused;
  * the metrics are ``loss``, ``last_micro_loss`` and ``grad_norm`` (no
    ``skipped``).
"""

from __future__ import annotations

from typing import Callable

import torch

from progen_tpu_torch.parallel.groups import Grid
from progen_tpu_torch.parallel.pipeline import (
    PipelineStage,
    StageLinks,
    _local_batch,
    _microbatches,
    boundary_like,
    reduce_stage_grads,
)
from progen_tpu_torch.training.optimizer import global_norm
from progen_tpu_torch.training.state import TrainState


def pipeline_1f1b_micro_step(model: PipelineStage, links: StageLinks,
                             chunks) -> torch.Tensor:
    """One micro-step through the 1F1B schedule over the microbatches
    ``chunks`` (each (rows, n + 1)); gradients accumulate in ``.grad``.
    Returns the mean of the microbatch losses on the last stage, 0
    elsewhere."""
    m, stages, p = len(chunks), model.stages, model.index
    last = stages - 1
    like = boundary_like(model, chunks[0].shape[0])
    acts, cts, ring = {}, {}, {}  # arrived activations and gradients;
    total = torch.zeros((), device=model.device)  # saved inputs

    def valid(i):
        return 0 <= i < m

    def stage_input(i, grad: bool):
        if model.first:
            with torch.set_grad_enabled(grad):
                return model.embed_tokens(chunks[i][..., :-1])
        x = (acts.pop(i) if model.last or not grad else ring.pop(i))
        return x.requires_grad_(True) if grad else x

    for t in range(m + 2 * last):
        f, b = t - p, t - 2 * last + p
        out_act = out_ct = None
        if valid(f) and model.last:  # fused: forward, head, backward
            x = stage_input(f, grad=True)
            loss = model.head_loss(model(x), chunks[f]) / m
            loss.backward()
            total = total + loss.detach()
            out_ct = None if model.first else x.grad
        elif valid(f):
            with torch.no_grad():
                x = stage_input(f, grad=False)
                out_act = model(x)
            if not model.first:
                ring[f] = x
        if valid(b) and not model.last:
            x = stage_input(b, grad=True)
            model(x).backward(cts.pop(b))
            out_ct = None if model.first else x.grad
        # the hops, pair by pair from the left, activation before gradient
        if p > 0:
            if valid(t - (p - 1)):  # stage p - 1 forwarded t - (p - 1)
                acts[t - (p - 1)] = links.recv_left(like)
            if valid(b):
                links.send_left(out_ct)
        if p < last:
            if valid(f):
                links.send_right(out_act)
            nb = t - 2 * last + p + 1  # stage p + 1's backward this tick
            if valid(nb):
                cts[nb] = links.recv_right(like)
    return total


def make_1f1b_train_step(grid: Grid, n_microbatches: int
                         ) -> Callable[[TrainState, torch.Tensor],
                                       tuple[TrainState, dict]]:
    """train_step(state, batch) -> (state, metrics) through the 1F1B
    schedule, for a state from ``pipeline.init_pipeline_state`` on
    ``grid``; every rank gets the whole global batch (grad_accum, rows,
    seq_len + 1) and steps together. See the module docstring for where
    it departs from the plain step."""
    links = StageLinks(grid)

    def train_step(state: TrainState, batch: torch.Tensor):
        model, opt = state.model, state.optimizer
        batch = _local_batch(model, batch, grid)
        params = opt.params
        for q in params.values():
            q.grad = None
        losses = torch.stack([
            pipeline_1f1b_micro_step(model, links,
                                     _microbatches(micro, n_microbatches))
            for micro in batch])
        reduce_stage_grads(params, losses, grid)
        grads = {n: q.grad.div_(batch.shape[0]) for n, q in params.items()}
        grad_norm = global_norm([], grads.values(), grid.model_group)
        opt.update(grads, grad_norm)  # no finite gate on this path
        for q in params.values():
            q.grad = None
        state.step += 1
        return state, {"loss": losses.mean(), "last_micro_loss": losses[-1],
                       "grad_norm": grad_norm}

    return train_step
