"""Causal spatial mixing for the gMLP spatial gating unit: the gate is
mixed across the sequence axis by a learned causally-masked (n, n)
matrix, plus a per-position bias, accumulated in float32.

``block_size > 0`` selects the recursive block-triangular formulation:
the strictly-lower-left quadrant is a full product and only the two
diagonal quadrants recurse, so the structural zeros are never
multiplied. Same math, reassociated.
"""

from __future__ import annotations

import torch


def _dense_mix(gate: torch.Tensor, weights: torch.Tensor,
               row_offset: int = 0) -> torch.Tensor:
    """tril-masked dense mix, float32; ``weights`` row m is output row
    ``row_offset + m``."""
    w = torch.tril(weights.float(), diagonal=row_offset)
    return torch.einsum("...nd,mn->...md", gate.float(), w)


def _block_triangular_mix(gate: torch.Tensor, weights: torch.Tensor,
                          block_size: int) -> torch.Tensor:
    n = weights.shape[0]
    if n <= block_size or n % 2:
        return _dense_mix(gate, weights)
    h = n // 2
    g_top, g_bot = gate[..., :h, :], gate[..., h:, :]
    out_top = _block_triangular_mix(g_top, weights[:h, :h], block_size)
    lower_left = torch.einsum("...jd,mj->...md", g_top.float(),
                              weights[h:, :h].float())
    out_bot = lower_left + _block_triangular_mix(g_bot, weights[h:, h:],
                                                 block_size)
    return torch.cat([out_top, out_bot], dim=-2)


def causal_sgu_mix(gate: torch.Tensor, weights: torch.Tensor,
                   biases: torch.Tensor, block_size: int = 0,
                   row_offset: int = 0):
    """gate: (..., n, d); weights: (n, n), row m attends to columns <= m;
    biases: (n, 1). Returns (..., n, d) in gate.dtype:
    out[m] = sum_{j<=m} W[m, j] gate[j] + b[m].

    A sequence shard passes the rows [r0, r0 + rows) of the weights and
    biases and ``row_offset=r0`` with the whole gate, and gets those rows
    of the output: (..., rows, d). Only the dense mix takes an offset."""
    gate32 = gate.float()
    if block_size > 0:
        if row_offset:
            raise ValueError("the block-triangular mix takes no row offset")
        mixed = _block_triangular_mix(gate32, weights, block_size)
    else:
        mixed = _dense_mix(gate32, weights, row_offset)
    mixed = mixed + biases.float()
    return mixed.to(gate.dtype)
