"""The ProGen model: a decoder-only protein language model, batch-first.

Counterpart of ``progen_tpu/models/progen.py``: token embedding ->
``depth`` x (local attention + feed-forward) with residual adds, the last
``global_mlp_depth`` layers using gMLP feed-forwards (spatial gate, no
GLU), then a scale-only norm and a linear logits head. Params in
``config.param_dtype`` (float32 by default), compute in ``config.dtype``,
logits in float32.

``forward`` runs the full sequence through the kernels; given a
``parallel.Grid`` whose seq axis is above 1, it runs this rank's shard of
each sequence (see ``models/layers.py``). With
``config.remat`` set and autograd recording, each attention and each
feed-forward block is recomputed in the backward
(``torch.utils.checkpoint``), the counterpart of ``nn.remat`` per block.
``decode_step``
takes one token per row and carries a ``DecodeCache`` (rolling 2-window
K/V ring, token-shift states, SGU gate history), as the JAX model's
``config.decode`` mode does; its logits at each position equal the full
forward's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from progen_tpu_torch._device import resolve_device
from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.models.layers import (
    AttnCache,
    Dense,
    FFCache,
    FeedForwardBlock,
    LocalAttentionBlock,
    ScaleNorm,
)
from progen_tpu_torch.ops.rotary import fixed_pos_embedding


@dataclasses.dataclass
class DecodeCache:
    """Per-layer decode state plus the shared position; ``decode_step``
    updates every tensor in place and advances ``pos``."""

    attn: list[AttnCache]
    ff: list[FFCache]
    pos: int = 0


def _truncated_normal(shape, stddev: float, gen: torch.Generator):
    """Normal truncated to [-2, 2] standard deviations, times ``stddev``
    (jax.random.truncated_normal(-2, 2) * stddev)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen)
    x = math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)
    return x.clamp(-2, 2) * stddev


def _lecun_normal(out_features: int, in_features: int,
                  gen: torch.Generator):
    # variance_scaling(1, fan_in, truncated_normal): the std of a
    # [-2, 2]-truncated unit normal is .87962566103423978
    std = math.sqrt(1.0 / in_features) / .87962566103423978
    return _truncated_normal((out_features, in_features), std, gen)


class ProGen(nn.Module):
    def __init__(self, config: ProGenConfig, *, device="cuda",
                 seed: int | None = 0):
        super().__init__()
        dev = resolve_device(device)
        c = config
        self.config = c
        pd = c.params_dtype
        self.embed = nn.Parameter(torch.empty(c.num_tokens, c.dim, dtype=pd))
        self.attn = nn.ModuleList()
        self.ff = nn.ModuleList()
        for i in range(c.depth):
            use_gmlp = (c.depth - i) <= c.global_mlp_depth
            self.attn.append(LocalAttentionBlock(c))
            self.ff.append(FeedForwardBlock(
                c, glu=(not use_gmlp) and c.ff_glu, spatial_gate=use_gmlp
            ))
        self.norm = ScaleNorm(c.dim, c.layer_norm_epsilon, pd)
        self.to_logits = Dense(c.dim, c.num_tokens, param_dtype=pd)
        if seed is not None:  # None: the caller loads a state dict next
            self.reset_parameters(seed)
        self.to(dev)
        self._rope: dict = {}

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Seeded initialisers that mirror flax's: truncated normal 0.02
        for the embedding, lecun-normal for every Dense weight, zeros for
        Dense biases, ones for norm scales and SGU biases, uniform
        +-sgu_init_eps/seq_len for the SGU weights. Drawn on the CPU in a
        fixed order, so a seed gives the same weights on any device."""
        c = self.config
        gen = torch.Generator().manual_seed(int(seed))
        eps = c.sgu_init_eps / c.seq_len
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "embed":
                value = _truncated_normal(p.shape, 0.02, gen)
            elif leaf == "weight":
                value = _lecun_normal(p.shape[0], p.shape[1], gen)
            elif leaf == "spatial_weights":
                value = (torch.rand(p.shape, generator=gen) * 2 - 1) * eps
            elif leaf in ("scale", "spatial_biases"):
                value = torch.ones(p.shape)
            elif leaf == "bias":
                value = torch.zeros(p.shape)
            else:
                raise AssertionError(f"no initialiser for {name}")
            p.copy_(value.to(p.dtype))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tables(self, n: int):
        key = (n, self.device)
        if key not in self._rope:
            self._rope[key] = fixed_pos_embedding(
                n, self.config.dim_head, device=self.device
            )
        return self._rope[key]

    def _embed(self, tokens):
        return F.embedding(tokens.long(),
                           self.embed.to(self.config.compute_dtype))

    def _logits(self, x):
        c = self.config
        return self.to_logits(self.norm(x, c.compute_dtype),
                              c.compute_dtype).float()

    def forward(self, tokens: torch.Tensor, grid=None) -> torch.Tensor:
        """tokens (batch, n) ints -> float32 logits (batch, n, num_tokens).

        With ``grid`` (``parallel.Grid``) of seq size S > 1, ``tokens`` are
        this rank's positions ``grid.seq_slice(S * n)`` of each sequence,
        and the logits are theirs; every rank of the seq group calls
        forward together, as its collectives need."""
        n = tokens.shape[-1]
        if n % self.config.window_size:
            raise ValueError("sequence length must be a multiple of "
                             f"window_size={self.config.window_size}")
        group = grid.seq_group if grid is not None and grid.seq > 1 else None
        x = self._embed(tokens)
        if group is None:
            sin, cos = self._tables(n)
        else:  # this shard's rows of the whole sequence's tables
            rows = grid.seq_slice(n * grid.seq)
            sin, cos = (t[rows] for t in self._tables(n * grid.seq))
        remat = self.config.remat and torch.is_grad_enabled()
        for attn, ff in zip(self.attn, self.ff):
            if remat:
                # the recompute runs the block's collectives again, on
                # every rank in the same order
                x = x + checkpoint(attn, x, sin, cos, group,
                                   use_reentrant=False)
                x = x + checkpoint(ff, x, group, use_reentrant=False)
            else:
                x = x + attn(x, sin, cos, group)
                x = x + ff(x, group)
        return self._logits(x)

    def init_cache(self, batch: int) -> DecodeCache:
        """A fresh, zeroed decode state for ``batch`` rows at position 0."""
        dev = self.device
        return DecodeCache(
            attn=[a.new_cache(batch, dev) for a in self.attn],
            ff=[f.new_cache(batch, dev) for f in self.ff],
        )

    def decode_step(self, tokens: torch.Tensor,
                    cache: DecodeCache) -> torch.Tensor:
        """Feed the token at ``cache.pos`` of every row: tokens (batch,)
        or (batch, 1) -> float32 logits (batch, num_tokens) for the next
        position. Updates ``cache`` in place and advances its position."""
        pos = cache.pos
        if pos >= self.config.seq_len:
            raise ValueError(f"decode position {pos} is past seq_len")
        x = self._embed(tokens.reshape(-1, 1))
        sin, cos = self._tables(self.config.seq_len)
        for attn, ff, ac, fc in zip(self.attn, self.ff, cache.attn,
                                    cache.ff):
            x = x + attn.decode(x, sin, cos, pos, ac)
            x = x + ff.decode(x, pos, fc)
        cache.pos = pos + 1
        return self._logits(x)[:, 0]
