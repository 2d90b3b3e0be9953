"""Optimizer: global-norm clip + weight-decay-masked AdamW, with optax's
numbers.

Counterpart of ``progen_tpu/training/optimizer.py``, which chains
``optax.clip_by_global_norm(max_grad_norm)`` and ``optax.adamw(lr,
weight_decay, mask=ndim > 1)``. Where PyTorch's own pieces differ, this
module follows optax:

* the clip has no epsilon: ``g / norm * max_norm`` only when
  ``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6``);
* weight decay applies to every parameter with ``ndim > 1``, the SGU's
  (n, n) weights and (n, 1) biases included, and is added to the Adam
  direction before the learning rate scales it;
* the learning rate of an update is ``schedule(count)`` with ``count``
  the number of updates made BEFORE it, so the first update of a warmup
  has lr 0 (``LambdaLR`` counts otherwise).

``MaskedAdamW`` holds its moments and its count and updates them and the
parameters in place. The moments take the parameters' dtype, as optax's
``zeros_like`` gives them: bfloat16 parameters get bfloat16 moments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

SCHEDULES = ("constant", "cosine")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, as the JAX package


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The arguments of the JAX package's ``make_optimizer``, with its
    defaults. ``schedule``: "constant", or "cosine" (linear warmup from 0
    over ``warmup_steps``, then cosine decay to 10% of peak at
    ``total_steps``)."""

    learning_rate: float = 2e-4
    weight_decay: float = 1e-3
    max_grad_norm: float = 0.5
    _: dataclasses.KW_ONLY
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.schedule == "cosine" and \
                self.total_steps <= self.warmup_steps:
            raise ValueError(
                f"cosine schedule needs total_steps ({self.total_steps}) > "
                f"warmup_steps ({self.warmup_steps})"
            )


def learning_rate(config: OptimizerConfig, count: int) -> float:
    """The learning rate of the update made after ``count`` updates, as
    ``optax.warmup_cosine_decay_schedule(0, peak, warmup, total, 0.1 *
    peak)`` gives it for "cosine"."""
    peak = config.learning_rate
    if config.schedule == "constant":
        return peak
    warmup = config.warmup_steps
    if count < warmup:  # linear_schedule(0, peak, warmup)
        frac = 1 - count / warmup
        return (0.0 - peak) * frac + peak
    decay_steps = config.total_steps - warmup
    t = min(count - warmup, decay_steps)
    cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
    return peak * ((1 - 0.1) * cosine + 0.1)


def weight_decay_mask(params: dict[str, torch.Tensor]) -> dict[str, bool]:
    """True for the parameters that receive weight decay: rank >= 2."""
    return {name: p.ndim > 1 for name, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> None:
    """In place: each g becomes ``g / norm * max_norm`` when ``norm >=
    max_norm`` (no epsilon), as optax.clip_by_global_norm selects it."""
    if norm is None:
        norm = global_norm(grads.values())
    keep = norm < max_norm
    for g in grads.values():
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class MaskedAdamW:
    """clip_by_global_norm + AdamW with the decay masked to rank >= 2,
    holding ``count`` (updates made) and the moments ``mu``, ``nu`` keyed
    like the model's state_dict. ``update`` changes the moments, the count
    and the parameters in place."""

    def __init__(self, model: nn.Module, config: OptimizerConfig):
        self.config = config
        self.params = dict(model.named_parameters())
        self.decay = weight_decay_mask(self.params)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor],
               norm: torch.Tensor | None = None) -> None:
        """One update from ``grads`` (same keys as the parameters; clipped
        here, in place). ``norm``: their global norm, when known."""
        c = self.config
        clip_by_global_norm(grads, c.max_grad_norm, norm)
        lr = learning_rate(c, self.count)
        count = self.count + 1
        # optax takes 1 - decay**count in float32
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        for name, p in self.params.items():
            g, mu, nu = grads[name], self.mu[name], self.nu[name]
            # (1 - b) * g**k + b * moment, in optax's order
            mu.mul_(B1).add_(g * (1 - B1))
            nu.mul_(B2).add_(g.square() * (1 - B2))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.decay[name]:
                u = u + c.weight_decay * p
            p.add_(-lr * u)
        self.count = count

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``count`` and the moments in (tensors on any device)."""
        for ours, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if ours.keys() != theirs.keys():
                raise KeyError("moment keys differ from the parameters'")
            for name, t in theirs.items():
                ours[name].copy_(t)
        self.count = int(state["count"])
