"""Per-sequence scoring: the core step of batch scoring and evaluation."""

from __future__ import annotations

import numpy as np
import torch

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.training.loss import sequence_scores


@torch.inference_mode()
def score_step(model, batch, *, device="cuda"):
    """(B, n+1) collated int batch (BOS column first) -> (per_seq_nll (B,),
    per_token_logprob (B, n), mask (B, n)). A model with gMLP layers is
    bound to its seq_len, so n must equal it there."""
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.asarray(batch))
    batch = batch.to(device=dev, dtype=torch.long)
    ids, labels = batch[..., :-1], batch[..., 1:]
    return sequence_scores(model(ids), labels)
