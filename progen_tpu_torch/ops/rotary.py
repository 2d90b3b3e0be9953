"""Rotary position embeddings, GPT-J interleaved layout.

``inv_freq`` over even dims, an outer product with positions, each
frequency duplicated onto adjacent feature pairs, and the pairwise
(-x2, x1) rotation. The tables are built in float32 and cast to the
input's dtype when applied.
"""

from __future__ import annotations

import torch


def fixed_pos_embedding(seq_len: int, dim: int, offset: int = 0,
                        device=None):
    """(sin, cos) tables of shape (seq_len, dim) in float32; ``dim`` even."""
    inv_freq = 1.0 / (
        10000 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                               device=device) / dim)
    )
    pos = torch.arange(offset, offset + seq_len, dtype=torch.float32,
                       device=device)
    sinusoid = torch.outer(pos, inv_freq)
    # (n, dim/2) -> (n, dim) with layout f0 f0 f1 f1 ...
    sinusoid = torch.repeat_interleave(sinusoid, 2, dim=-1)
    return torch.sin(sinusoid), torch.cos(sinusoid)


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2, x3, x4, ...) -> (-x2, x1, -x4, x3, ...) over the last axis."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    return torch.stack((-x2, x1), dim=-1).reshape(x.shape)


def apply_rotary_pos_emb(x: torch.Tensor, sin: torch.Tensor,
                         cos: torch.Tensor) -> torch.Tensor:
    """Rotate the first ``rot_dim`` features of x: (..., n, d); sin/cos
    (n, rot_dim) with rot_dim <= d. Features beyond rot_dim pass."""
    rot_dim = sin.shape[-1]
    sin = sin.to(x.dtype)
    cos = cos.to(x.dtype)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x_rot = x_rot * cos + rotate_every_two(x_rot) * sin
    if x_pass.shape[-1] == 0:
        return x_rot
    return torch.cat((x_rot, x_pass), dim=-1)
