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

On a grid: a tensor-parallel model's parameters are its shards, and
``global_norm`` sums the shards' squares over the model group and counts
each replicated tensor once, so the clip sees the single process's norm.
With ``zero1`` (``parallel.partition.Zero1``) the moments are cut over
the data group: each rank updates its slice of the moments and the
parameters from the whole (all-reduced) gradients, then the parameter
slices are all-gathered.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from progen_tpu_torch.parallel.partition import Zero1, zero1_dim
from progen_tpu_torch.parallel.tensor import layout
from progen_tpu_torch.telemetry.spans import span

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


def _scaled(t: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``t`` times a float32 ``factor`` on the card, as the card multiplies
    by a Python number: in float32, rounded once to t's dtype."""
    if t.dtype == torch.float32:
        return t * factor
    return (t.float() * factor).to(t.dtype)


def _squares(tensors) -> torch.Tensor:
    return sum(t.float().square().sum() for t in tensors)


def global_norm(tensors, sharded=(), group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm.
    With ``group``: ``sharded`` are shards over that group, whose squares
    are summed over it, and ``tensors`` are replicated there, counted
    once."""
    total = _squares(tensors)
    if group is not None:
        sq = _squares(sharded)  # a new tensor: reduced in place
        dist.all_reduce(sq, group=group)
        total = total + sq
    return torch.sqrt(total)


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
    and the parameters in place. With ``zero1``, ``mu`` and ``nu`` hold
    this rank's slices (``cut``: each tensor's dim, or None when whole);
    ``state_dict`` and ``load_state_dict`` still speak of whole ones.
    ``update`` opens the spans ``step/clip``, ``step/adamw`` (the
    per-tensor loop) and, with ZeRO-1, ``step/zero1_gather``."""

    def __init__(self, model: nn.Module, config: OptimizerConfig,
                 zero1: Zero1 | None = None):
        self.config = config
        self.params = dict(model.named_parameters())
        self.decay = weight_decay_mask(self.params)
        self.zero1 = zero1
        tp = getattr(model, "tp", None)

        def tp_dim(name):
            spec = layout(name, model.config) if tp is not None else None
            return None if spec is None else spec[0]

        self.cut = {n: (zero1_dim(p.shape, tp_dim(n), zero1.size)
                        if zero1 is not None else None)
                    for n, p in self.params.items()}
        self.mu = {n: torch.zeros_like(self._mine(n, p))
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(self._mine(n, p))
                   for n, p in self.params.items()}
        self.count = 0

    def _mine(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole (parameter-shaped) tensor."""
        if self.zero1 is None:
            return t
        return self.zero1.slice(t, self.cut[name])

    def factors(self) -> tuple[float, float, float]:
        """The next update's learning rate and its bias corrections
        1 - b1**k and 1 - b2**k, k its count from 1."""
        count = self.count + 1
        # optax takes 1 - decay**count in float32
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        return learning_rate(self.config, self.count), bc1, bc2

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor],
               norm: torch.Tensor | None = None,
               factors: torch.Tensor | None = None) -> None:
        """One update from ``grads`` (same keys as the parameters; clipped
        here, in place). ``norm``: their global norm, when known.
        ``factors``: for an update captured in a CUDA graph, three
        float32 on the card that ``stage`` fills before each replay; the
        kernels read the factors there, and this call leaves ``count``
        alone."""
        c = self.config
        with span("step/clip"):
            clip_by_global_norm(grads, c.max_grad_norm, norm)
        lr, bc1, bc2 = self.factors()
        if factors is not None:
            neg_lr, inv1, inv2 = factors.unbind()
        with span("step/adamw"):
            for name, whole in self.params.items():
                # with ZeRO-1, views of this rank's slices: the update
                # is elementwise, so each element is the one the whole
                # would get
                p = self._mine(name, whole)
                g = self._mine(name, grads[name])
                mu, nu = self.mu[name], self.nu[name]
                # (1 - b) * g**k + b * moment, in optax's order
                mu.mul_(B1).add_(g * (1 - B1))
                nu.mul_(B2).add_(g.square() * (1 - B2))
                if factors is None:
                    u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
                else:
                    u = _scaled(mu, inv1) / (torch.sqrt(_scaled(nu, inv2))
                                             + EPS)
                if self.decay[name]:
                    u = u + c.weight_decay * p
                p.add_(-lr * u if factors is None else _scaled(u, neg_lr))
        if self.zero1 is not None:
            names = list(self.params)
            with span("step/zero1_gather"):
                self.zero1.gather_([self.params[n] for n in names],
                                   [self.cut[n] for n in names])
        if factors is None:
            self.count += 1

    def stage(self, factors: torch.Tensor) -> None:
        """Fill ``factors`` for the next replay of an update captured with
        them, and count that update: -lr, 1 / bc1 and 1 / bc2 in
        float32, the numbers the card's kernels take from ``update``'s
        Python ones (they multiply by a divisor's reciprocal). Three
        fills, no copy from the host."""
        lr, bc1, bc2 = self.factors()
        one = np.float32(1)
        values = (np.float32(-lr), one / np.float32(bc1),
                  one / np.float32(bc2))
        for slot, value in zip(factors.unbind(), values):
            slot.fill_(float(value))
        self.count += 1

    def state_dict(self) -> dict:
        """``count`` and the whole moments. With ZeRO-1 they are gathered
        over the data group: every rank of it calls this together."""
        if self.zero1 is None:
            return {"count": self.count, "mu": dict(self.mu),
                    "nu": dict(self.nu)}
        return {"count": self.count,
                **{key: {n: self.zero1.gather(t, self.cut[n])
                         for n, t in moments.items()}
                   for key, moments in (("mu", self.mu), ("nu", self.nu))}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``count`` and the whole moments in (tensors on any
        device); with ZeRO-1 each rank keeps its slices."""
        for ours, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if ours.keys() != theirs.keys():
                raise KeyError("moment keys differ from the parameters'")
            for name, t in theirs.items():
                ours[name].copy_(self._mine(name, t))
        self.count = int(state["count"])
