"""Plain float32 training steps of the yardstick: the mean over a batch
of the per-sequence loss, gradients averaged over the accumulation
axis, a global-norm clip and AdamW with weight decay on the tensors of
rank 2 or more, in optax's arithmetic (``clip_by_global_norm``, then
``adamw``: moments as (1 - b) g^k + b m, bias corrections taken in
float32, the decay added to the Adam direction before the learning rate
scales it). Rows run in blocks of ``rows_per_block`` so that the
float32 activations of one block fit beside the state."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class Optimizer:
    learning_rate: float = 2e-4
    weight_decay: float = 1e-3
    max_grad_norm: float = 0.5


def leaf_norms(tensors: dict) -> dict:
    """name -> the float64 norm of each tensor, as a Python float."""
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def train(params: dict, spec, batches: list, opt: Optimizer, *,
          rows_nll, rows_per_block: int, linear=F.linear) -> dict:
    """``len(batches)`` steps from ``params`` (name -> float32 tensor,
    left unchanged). Each batch: (grad_accum, micro_batch, n + 1)
    tokens; ``rows_nll`` is the family's plain per-sequence loss
    (``families/``). Returns the loss of each step, the norm of each
    tensor's first gradient as the optimizer takes it (clipped), and the
    norm of each tensor's change over all the steps."""
    p = {n: t.detach().clone().requires_grad_(True)
         for n, t in params.items()}
    mu = {n: torch.zeros_like(t) for n, t in p.items()}
    nu = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first_grads = [], None
    for count, batch in enumerate(batches, start=1):
        accum, micro, _ = batch.shape
        total = torch.zeros((), dtype=torch.float64,
                            device=next(iter(p.values())).device)
        for t in p.values():
            t.grad = None
        for a in range(accum):
            for r in range(0, micro, rows_per_block):
                rows = torch.as_tensor(batch[a, r:r + rows_per_block]).to(
                    total.device)
                per_seq = rows_nll(p, spec, rows, linear)
                (per_seq.sum() / (micro * accum)).backward()
                total += per_seq.detach().double().sum()
        losses.append(float(total) / (micro * accum))
        with torch.no_grad():
            grads = {n: t.grad for n, t in p.items()}
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            if norm >= opt.max_grad_norm:
                for g in grads.values():
                    g.div_(norm).mul_(opt.max_grad_norm)
            if first_grads is None:
                first_grads = leaf_norms(grads)
            bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
            for n, t in p.items():
                g = grads[n]
                mu[n].mul_(B1).add_(g * (1 - B1))
                nu[n].mul_(B2).add_(g.square() * (1 - B2))
                u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + EPS)
                if t.ndim > 1:
                    u = u + opt.weight_decay * t
                t.sub_(opt.learning_rate * u)
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(
            (p[n] - params[n]).double())) for n in p}
    return {"losses": losses, "grad_norms": first_grads,
            "change_norms": change}
