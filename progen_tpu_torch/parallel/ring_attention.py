"""Sequence-parallel windowed attention by a one-window halo exchange.

Counterpart of ``progen_tpu/parallel/ring_attention.py:104``. A query
window sees at most the previous window, so a sequence shard needs one
window of keys and values from its left neighbour; the first shard takes
zeros, which are the reference's phantom keys of window 0. Each rank then
runs kernel A4 (``local_attention`` with ``halo_k``, ``halo_v``) on its
shard.

The reference's policy table, its ``check_vma`` switch and its
telemetry records (``ring_attention.py:35-101``, ``:133-219``) choose
TPU kernels and steer JAX's ``shard_map`` checker; they have no
counterpart here. The reference runs inside ``shard_map`` on the global
arrays; this function runs on each rank's shard, in the rank's process.
"""

from __future__ import annotations

import torch

from progen_tpu_torch.ops.cuda_attention import local_attention
from progen_tpu_torch.parallel.collectives import halo_from_left


def ring_local_attention(q, k, v, window_size: int, group, scale=None,
                         bwd_impl: str = "kv") -> torch.Tensor:
    """q, k, v: this rank's shard (batch, heads, n/S, dim_head) of a
    sequence split in S = ``group``'s size, shards in rank order. Returns
    the shard of the whole sequence's local attention, (batch, heads, n/S,
    dim_head), differentiable through the halo exchange."""
    n, w = q.shape[2], window_size
    if n % w:
        raise ValueError(f"shard length {n} must be whole {w}-token windows")
    # k's and v's last windows in one exchange
    halo = halo_from_left(torch.stack((k[:, :, -w:], v[:, :, -w:])), group)
    return local_attention(q, k, v, w, scale, bwd_impl, halo_k=halo[0],
                           halo_v=halo[1])
