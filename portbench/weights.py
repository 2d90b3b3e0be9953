"""Seeded weights, made on the device in one large draw.

The benchmark makes the weights itself and hands the same ones to the
program and to the reference. Each parameter's kind (its family's
``Spec.parameter_shapes``) picks its scale and shift from the family's
``SCALES``: the scale of a model in use rather than of a fresh init, so
that every layer shapes the output.
"""

from __future__ import annotations

import math

import torch


def make(spec, seed: int, device, scales: dict) -> dict:
    """name -> tensor of every parameter, drawn from ``seed`` on
    ``device``: one normal draw for all of them, then scaled in place
    and shifted by ``scales[kind]`` (scale(shape, spec), shift). The
    tensors are views of one buffer; the same seed on the same device
    gives the same values."""
    shapes = spec.parameter_shapes()
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        k = math.prod(shape)
        t = flat[at:at + k].view(shape)
        scale, shift = scales[kind]
        t.mul_(scale(shape, spec))
        if shift:
            t.add_(shift)
        out[name] = t
        at += k
    return out
