"""The single-card train step, captured as CUDA graphs and replayed.

From Python, a step at base launches some 14,000 kernels one by one; the
card idles between them while the host runs autograd's bookkeeping. A
replay launches the same kernels back to back. ``make_train_step``
captures its step as graphs on either side of the finite gate, whose
read stays the step's one wait on the card:

* graph A: one micro-batch's forward and backward (remat's recompute
  inside), summing into static gradients, replayed for each micro-batch
  of the step on a static buffer that the micro-batch is copied into
  (the batch comes in whole with one ``copy_``); captured for one
  micro-batch, it costs one micro-batch's capture, however many a step
  accumulates;
* graph N: the gradients' division by the accumulation count and their
  norm; A's and N's losses and norm feed the gate;
* graph B: ``MaskedAdamW.update``'s clip and AdamW loop, reading the
  learning rate and the bias corrections from three float32 on the card
  that ``MaskedAdamW.stage`` fills from ``count``; replayed only when
  the gate passes, so a refused step leaves the parameters, the moments
  and the count as they were.

The graphs hold only where the step can see that they hold (``key_of``):
the batch's shape and dtype, the model and optimizer objects, the
optimizer's settings, the storages of the parameters and the moments,
and the attention backward the model's blocks choose. The first call on
a key runs the eager step, which loads the kernels and fills the
allocator; the next call on it captures, then replays. One key at a
time: a call on another drops the graphs and runs eagerly.

A replay runs none of the kernel wrappers, so it credits each wrapper
with the launches counted while its graph was captured
(``ops/launches.py``), and a replayed step counts as an eager one does.
"""

from __future__ import annotations

import gc
import itertools

import torch

from progen_tpu_torch.models import layers
from progen_tpu_torch.ops import launches


def replayable(model, grid) -> bool:
    """Whether a step of ``model`` may replay: on the card, no grid."""
    return grid is None and model.device.type == "cuda"


def key_of(state, batch: torch.Tensor) -> tuple:
    """What a capture on ``batch`` for ``state`` holds for."""
    opt = state.optimizer
    tensors = itertools.chain(opt.params.values(), opt.mu.values(),
                              opt.nu.values())
    return (tuple(batch.shape), batch.dtype, id(state.model), id(opt),
            opt.config, layers.ATTN_BWD_IMPL,
            tuple(t.data_ptr() for t in tensors))


def _capture(graph, body, pool=None) -> tuple:
    """Record ``body()`` into ``graph`` (in ``pool``): its result, and the
    launches the wrappers counted meanwhile, taken back out of their
    counts, since a capture records kernels and runs none."""
    before = launches.launch_counts()
    with torch.cuda.graph(graph, pool=pool):
        out = body()
    seen = {rid: n - before[rid]
            for rid, n in launches.launch_counts().items()
            if n != before[rid]}
    launches.credit({rid: -n for rid, n in seen.items()})
    return out, seen


class Captured:
    """The graphs of one key: A (one micro-batch's forward and backward,
    replayed for each micro-batch of a step), N (the gradients' mean and
    norm) and B (the update); the static tensors they read and write;
    and the launches counted while capturing each. It holds the state
    it was captured for, so that what the graphs point at (the model's
    rotary tables among it) stays allocated."""

    def __init__(self, key: tuple, state, batch: torch.Tensor, micro_step,
                 average):
        """Capture for ``batch`` (on the card, kept as the static batch).
        ``micro_step(micro)`` runs a micro-batch's forward and backward
        and returns its loss; ``average(grads)`` divides the summed
        gradients in place and returns their norm."""
        opt = state.optimizer
        # a graph that the cycle collector frees while another is being
        # captured breaks that capture: free the dead ones first
        gc.collect()
        self.key, self.state, self.batch = key, state, batch
        self.micro = batch[0].clone()
        self.factors = torch.zeros(3, dtype=torch.float32,
                                   device=batch.device)
        # the backward sums into gradients that exist, so that one graph
        # serves every micro-batch; zeroed before each step's first
        self.grads = {n: torch.zeros_like(p) for n, p in opt.params.items()}
        for n, p in opt.params.items():
            p.grad = self.grads[n]
        self.a, self.n, self.b = (torch.cuda.CUDAGraph() for _ in range(3))
        self.loss, self.launches_a = _capture(
            self.a, lambda: micro_step(self.micro))
        self.losses = torch.empty(len(batch), dtype=self.loss.dtype,
                                  device=batch.device)
        pool = self.a.pool()
        self.grad_norm, self.launches_n = _capture(
            self.n, lambda: average(self.grads), pool)
        # the class's own update: a wrapper set on the instance (a timer,
        # a recorder) is host code, which a replay would skip
        _, self.launches_b = _capture(
            self.b, lambda: type(opt).update(opt, self.grads, self.grad_norm,
                                             factors=self.factors), pool)
        for p in opt.params.values():
            p.grad = None  # the graphs keep them in ``grads``

    def accumulate(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Graph A on each micro-batch of the static batch, then graph N:
        copies of the losses and the norm, which the next replay does
        not overwrite."""
        torch._foreach_zero_(list(self.grads.values()))
        for k, micro in enumerate(self.batch):
            self.micro.copy_(micro)
            self.a.replay()
            self.losses[k].copy_(self.loss)
            launches.credit(self.launches_a)
        self.n.replay()
        launches.credit(self.launches_n)
        return self.losses.clone(), self.grad_norm.clone()

    def update(self) -> None:
        """Graph B, after graph N: one optimizer update, counted."""
        self.state.optimizer.stage(self.factors)
        self.b.replay()
        launches.credit(self.launches_b)
