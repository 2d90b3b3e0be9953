"""The collectives of data- and sequence-parallel training, as autograd
functions over a process group.

* ``halo_from_left``: every rank gets its left neighbour's block (its
  last window of keys and values, its last row of activations) and rank 0
  gets zeros, as ``ring_attention.py:143-149`` sends one window a hop to
  the right over ``ppermute`` and zeroes shard 0's. The backward sends the
  halo's gradient back to the neighbour, which adds it to its block.
* ``gather_seq``: the shards concatenated along the sequence; the
  backward gives each rank its slice of the gradient summed over the
  group.
* ``all_reduce_`` and ``broadcast_``: one bucketed collective over many
  tensors, in place (the train step's gradients, the initial
  parameters).

All of them are built on ``all_gather``, ``all_reduce`` and ``broadcast``
alone, which both NCCL and gloo carry for CUDA tensors (gloo is what
several ranks on one card use). The halo exchange is therefore an
all-gather in which every rank receives every rank's block, where the
reference makes one point-to-point hop: at long8k with two shards a
block of k and v is 2 x 2 x 8 x 512 x 64 in bfloat16, 2 MiB a layer. A
one-hop exchange (``send``/``recv`` or ``batch_isend_irecv`` over NCCL)
is later work.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


class _HaloFromLeft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, group):
        ctx.group = group
        rank = dist.get_rank(group)
        parts = _all_gather(block, group)
        return torch.zeros_like(block) if rank == 0 else parts[rank - 1]

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        parts = _all_gather(g, ctx.group)
        # my block went to rank + 1 as its halo; the last rank's went to
        # nobody (rank 0 takes zeros)
        nxt = parts[rank + 1] if rank + 1 < len(parts) else \
            torch.zeros_like(g)
        return nxt, None


def halo_from_left(block: torch.Tensor, group) -> torch.Tensor:
    """The left neighbour's ``block`` (same shape), zeros on rank 0."""
    return _HaloFromLeft.apply(block, group)


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, t.shape[dim]
        return torch.cat(_all_gather(t, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        # each rank's share of the whole, summed over the ranks in
        # float32 and rounded once
        total = g.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        mine = total.narrow(ctx.dim, dist.get_rank(ctx.group) * ctx.size,
                            ctx.size)
        return mine.to(g.dtype), None, None


def gather_seq(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the group's shards of ``t`` along ``dim``, in rank
    order."""
    return _GatherSeq.apply(t, dim, group)


def _bucket(tensors):
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    return tensors, flat


def _unbucket(tensors, flat) -> None:
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_(tensors, group, scale: float = 1.0) -> None:
    """In place: each tensor becomes its sum over ``group`` times
    ``scale``, in one float32 all_reduce over all of them."""
    tensors, flat = _bucket(tensors)
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    _unbucket(tensors, flat)


@torch.no_grad()
def broadcast_(tensors, group, src: int = 0) -> None:
    """In place: every rank's tensors become global rank ``src``'s, in one
    broadcast."""
    tensors, flat = _bucket(tensors)
    dist.broadcast(flat, src=src, group=group)
    _unbucket(tensors, flat)
