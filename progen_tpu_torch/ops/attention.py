"""Windowed causal local attention, plain PyTorch.

The sequence is cut into n/w windows; each query window attends to its
own window plus the previous one (window 0's previous window is zeros);
the score mask is ``j <= i + w`` over the (w, 2w) block; masked scores
get -1e10. The zero keys of window 0 are NOT masked: window-0 queries
leak softmax mass to w zero-score, zero-value keys, as the reference
model does. Scores and softmax are float32; the probabilities are cast
to the input dtype before P·V, and the output is in q's dtype.
"""

from __future__ import annotations

import torch

ATTN_MASK_VALUE = -1e10


def _window_mask(window_size: int, device=None) -> torch.Tensor:
    """Boolean (w, 2w) mask: query i sees [previous | current] keys j with
    j <= i + w."""
    i = torch.arange(window_size, device=device)[:, None]
    j = torch.arange(2 * window_size, device=device)[None, :]
    return j <= i + window_size


def with_prev_window(t: torch.Tensor, first_prev: torch.Tensor | None):
    """(b, h, nw, w, d) -> (b, h, nw, 2w, d): each window's [previous |
    current] keys or values; window 0's previous is ``first_prev`` or
    zeros."""
    b, h, _, w, d = t.shape
    if first_prev is None:
        first_prev = torch.zeros((b, h, w, d), dtype=t.dtype,
                                 device=t.device)
    prev = torch.cat((first_prev[:, :, None].to(t.dtype), t[:, :, :-1]),
                     dim=2)
    return torch.cat((prev, t), dim=3)


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window_size: int,
    scale: float | None = None,
    mask_value: float = ATTN_MASK_VALUE,
    first_prev_k: torch.Tensor | None = None,
    first_prev_v: torch.Tensor | None = None,
) -> torch.Tensor:
    """q, k, v: (batch, heads, n, dim_head) with n % window_size == 0.
    Returns (batch, heads, n, dim_head) in q.dtype. ``first_prev_k/v``
    (batch, heads, window, dim_head) replace window 0's zero previous
    window."""
    b, h, n, d = q.shape
    w = window_size
    if n % w != 0:
        raise ValueError(f"sequence length {n} not divisible by window {w}")
    nw = n // w
    if scale is None:
        scale = d ** -0.5
    qw = q.reshape(b, h, nw, w, d)
    kw2 = with_prev_window(k.reshape(b, h, nw, w, d), first_prev_k)
    vw2 = with_prev_window(v.reshape(b, h, nw, w, d), first_prev_v)

    sim = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw2.float())
    sim = sim * scale
    sim = torch.where(_window_mask(w, q.device), sim,
                      torch.tensor(mask_value, dtype=sim.dtype,
                                   device=sim.device))
    sim = sim - sim.amax(dim=-1, keepdim=True)
    attn = torch.softmax(sim, dim=-1).to(q.dtype)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn, vw2.to(q.dtype))
    return out.reshape(b, h, n, d)
