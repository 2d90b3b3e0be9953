"""Seeded weights, made on the device in one large draw.

The benchmark makes the weights itself and hands the same ones to the
program and to the reference. Their scale is that of a model in use
rather than of a fresh init, so that every layer shapes the output:
dense weights N(0, 1/fan_in), the embedding N(0, 0.02^2), biases
N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), the SGU's spatial mix
N(0, 1/n) (an init at +-1e-3/n would leave the mix, and so kernel L2,
out of every output) and its biases 1 + N(0, 0.1^2).
"""

from __future__ import annotations

import math

import torch

_SCALE = {"embed": lambda shape, n: 0.02,
          "dense": lambda shape, n: 1.0 / math.sqrt(shape[1]),
          "bias": lambda shape, n: 0.02,
          "scale": lambda shape, n: 0.1,
          "spatial": lambda shape, n: 1.0 / math.sqrt(n),
          "spatial_bias": lambda shape, n: 0.1}
_SHIFT = {"scale": 1.0, "spatial_bias": 1.0}


def make(spec, seed: int, device) -> dict:
    """name -> tensor of every parameter, drawn from ``seed`` on
    ``device``: one normal draw for all of them, then scaled in place.
    The tensors are views of one buffer; the same seed on the same
    device gives the same values."""
    shapes = spec.parameter_shapes()
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        k = math.prod(shape)
        t = flat[at:at + k].view(shape)
        t.mul_(_SCALE[kind](shape, spec.seq_len))
        if kind in _SHIFT:
            t.add_(_SHIFT[kind])
        out[name] = t
        at += k
    return out
