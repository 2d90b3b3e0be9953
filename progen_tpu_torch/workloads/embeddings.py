"""Embeddings extraction: final-layer pooled representations.

The port's counterpart of the JAX package's ``workloads/embeddings.py``.
The representation is the output of the model's final scale-only norm
(the states before the logits head, ``ProGen.features``), mean-pooled
over non-pad positions in float32, whatever the compute dtype: the
usual protein-LM embedding (per-residue states averaged over the
sequence). On the card the forward runs the kernels A1, L1 and L2.
"""

from __future__ import annotations

import torch


@torch.inference_mode()
def embed_step(model, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, n) ints on the model's device (0 = pad) -> (B, dim)
    float32 mean-pooled final-norm states."""
    h = model.features(tokens).float()
    mask = (tokens != 0).float()[..., None]
    return (h * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)


def bucket_length(
    n: int, max_len: int, minimum: int = 8, fixed: bool = False
) -> int:
    """Smallest power of two >= n (floor ``minimum``), capped at
    ``max_len``, so a ragged request stream runs a few shapes. ``fixed``
    pads straight to max_len: gMLP models bind a (seq_len, seq_len) SGU
    matrix, so their full forward takes only full-width inputs (callers
    pass ``config.global_mlp_depth > 0``)."""
    if n > max_len:
        raise ValueError(f"sequence length {n} exceeds max_len {max_len}")
    if fixed:
        return max_len
    b = minimum
    while b < n:
        b *= 2
    return min(b, max_len)
