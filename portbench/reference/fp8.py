"""The control: the reference's products with weights in 8-bit floats.

Every product with a weight takes its operands rounded to float8 with
one scale per tensor (the amax over the format's largest value), as
8-bit training and inference round them: activations and weights to
e4m3 in the forward, the incoming gradient to e5m2 in the backward. The
sums run in float32. This is the step below the configuration's
bfloat16 that a later change might take; the benchmark's limits must
refuse it.
"""

from __future__ import annotations

import torch


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = top / amax
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        xq = _round(x, torch.float8_e4m3fn)
        wq = _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        y = xq @ wq.t()
        return y + b if b is not None else y

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _round(g, torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        gb = gq.reshape(-1, gq.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def linear(x, w, b=None):
    """``x @ w.T + b`` with the operands in float8 (see the module)."""
    return _Fp8Linear.apply(x, w, b)
