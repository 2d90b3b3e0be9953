"""L2's bfloat16 mix as the card's tensor-core kernel computes it
(``csrc/sgu_mix_gate.cu``: ``sgu_mix_tc_kernel``), written out in
PyTorch for ``tests/test_torch_kernels.py`` (against the TPU kernel) and
``tests/test_torch_cuda.py`` (against the card's kernel). It imports
torch and the port only.

The gate is normalised and rounded to bfloat16; W is zeroed above the
diagonal and split into two bfloat16 parts, hi = bf16(W) and lo =
bf16(W - hi); the mix is summed in float32 over tiles of 32 j from j = 0,
each tile adding hi·g and then lo·g (every product of two bfloat16
values is exact in float32).
"""

from __future__ import annotations

import torch

from progen_tpu_torch.ops import cuda_layers


def split_mix(x, gate, w, b, scale, eps, row0=0, split=True, tile=32):
    """Output rows [row0, row0 + x.shape[1]) of the SGU tail in bfloat16;
    ``w`` and ``b`` are those rows of the weights and biases, ``gate``
    the whole gate. ``split=False``: the mix of hi = bf16(W) alone.
    Returns the bfloat16 output and the float32 mix before the bias."""
    rows, n = w.shape
    g = cuda_layers.norm_reference(gate, scale, eps, torch.bfloat16).float()
    m = torch.arange(row0, row0 + rows)[:, None]
    w = torch.where(torch.arange(n)[None, :] <= m, w, 0.0)
    hi = w.bfloat16().float()
    lo = (w - hi).bfloat16().float() if split else 0 * hi
    acc = torch.zeros(x.shape[0], rows, x.shape[-1])
    for k0 in range(0, n, tile):
        gt = g[:, k0:k0 + tile]
        acc = acc + hi[:, k0:k0 + tile] @ gt
        acc = acc + lo[:, k0:k0 + tile] @ gt
    gate_mixed = (acc + b).bfloat16()
    return x * gate_mixed, acc


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The bfloat16 ulp at each value of ``a`` (in float32; subnormals
    take the smallest normal's)."""
    e = torch.floor(torch.log2(a.float().abs().clamp(min=2.0 ** -126)))
    return 2.0 ** (e - 7)
