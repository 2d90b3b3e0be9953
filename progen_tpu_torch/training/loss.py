"""EOS-masked per-sequence scoring and the training loss, the
counterpart of the JAX package's ``training/loss.py``.

The padding token 0 doubles as end-of-string, so the mask keeps every
non-pad position plus the first pad position (the EOS the model must
emit). A sequence's score is the masked mean over its kept positions;
the training loss is that per-sequence score, which the train step
averages over the batch (NOT a global masked mean).

Over vocab-parallel logits (a tensor-parallel model's, given its
``parallel.tensor.TP``) the training losses reduce the softmax's max and
sum of exponentials, and the target's logit, over the model group
(``vocab_token_logprobs``); ``token_logprobs`` and ``sequence_scores``
stay whole-vocabulary functions for the callers that need them.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.parallel.tensor import vocab_token_logprobs


def masked_mean(t: torch.Tensor, mask: torch.Tensor, dim=None):
    """Mean of ``t`` over positions where ``mask`` is set."""
    mask = mask.to(t.dtype)
    if dim is None:
        return (t * mask).sum() / mask.sum()
    return (t * mask).sum(dim=dim) / mask.sum(dim=dim)


def eos_loss_mask(targets: torch.Tensor, ignore_index: int = 0):
    """Positions that count: non-pad tokens plus the first pad position."""
    nonpad = targets != ignore_index
    first_pad = (~nonpad).long().cumsum(dim=-1) == 1
    return nonpad | first_pad


def token_logprobs(logits: torch.Tensor, targets: torch.Tensor):
    """``log p(target)`` per position: logits (..., n, vocab), targets
    (..., n) -> (..., n) float32."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logprobs, -1, targets.long()[..., None])[..., 0]


def sequence_scores(logits: torch.Tensor, targets: torch.Tensor, *,
                    ignore_index: int = 0):
    """(per_seq_nll, per_token_logprob, loss_mask); ``per_seq_nll`` has
    shape ``logits.shape[:-2]``, the other two (..., n)."""
    lp = token_logprobs(logits, targets)
    mask = eos_loss_mask(targets, ignore_index)
    return masked_mean(-lp, mask, dim=-1), lp, mask


def _logprobs(logits, targets, tp):
    if tp is None:
        return token_logprobs(logits, targets)
    return vocab_token_logprobs(logits, targets, tp)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  ignore_index: int = 0, tp=None) -> torch.Tensor:
    """logits (..., n, vocab), targets (..., n) -> per-sequence losses of
    shape ``logits.shape[:-2]``: the masked mean over each sequence's
    kept positions. Callers average over the batch. With ``tp``, logits
    are this rank's vocab columns (see the module docstring)."""
    mask = eos_loss_mask(targets, ignore_index)
    return masked_mean(-_logprobs(logits, targets, tp), mask, dim=-1)


def shard_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        positions: slice, *, ignore_index: int = 0,
                        tp=None) -> torch.Tensor:
    """A sequence shard's share of ``cross_entropy``: logits (..., n/S,
    vocab) at ``positions`` of each sequence, targets (..., n) the whole
    label rows. The mask is built from the whole row (the first pad may
    lie in another shard), then cut to ``positions``; the numerator is
    this shard's masked sum, the denominator the whole row's count of
    kept positions, a constant every rank computes from the row it holds
    (no collective). The shares summed over the seq group are the
    per-sequence losses: shape ``logits.shape[:-2]``."""
    mask = eos_loss_mask(targets, ignore_index)
    lp = _logprobs(logits, targets[..., positions], tp)
    num = (-lp * mask[..., positions].to(lp.dtype)).sum(dim=-1)
    return num / mask.sum(dim=-1).to(lp.dtype)
