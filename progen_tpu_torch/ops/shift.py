"""Token shift: the first ``d - d//2`` feature channels are delayed one
position along the sequence (zero-filled at the front)."""

from __future__ import annotations

import torch


def shift_tokens(x: torch.Tensor,
                 shift_state: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., n, d) -> same shape. ``shift_state`` (..., 1, d - d//2),
    when given, is shifted into position 0 instead of zeros: incremental
    decoding carries the previous token's features through it."""
    d = x.shape[-1]
    split = d - d // 2
    x_shift, x_pass = x[..., :split], x[..., split:]
    if shift_state is None:
        shift_state = torch.zeros_like(x_shift[..., :1, :])
    x_shift = torch.cat((shift_state, x_shift[..., :-1, :]), dim=-2)
    return torch.cat((x_shift, x_pass), dim=-1)
