"""The process grid of data- and sequence-parallel training.

Counterpart of ``progen_tpu/parallel/partition.py``'s
``initialize_distributed`` (:135), of ``make_mesh`` (:216) restricted to
its ``data`` and ``seq`` axes, and of ``put_batch`` (:367). The ranks are
laid out as that mesh lays out its devices, ``rank = data_index * seq +
seq_index``, so the ranks of one sequence are neighbours.

Every rank holds the whole parameters (replicated, as the reference's
data and seq axes leave them). A data group is the ranks that hold one
sequence shard of different batch rows; a seq group is the ranks that
hold the shards of the same rows.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, seq) grid and its process groups."""

    data: int
    seq: int
    rank: int
    data_index: int
    seq_index: int
    world_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    seq_group: dist.ProcessGroup

    def seq_slice(self, n: int) -> slice:
        """This rank's positions of a whole sequence of length ``n``:
        [seq_index * n / seq, (seq_index + 1) * n / seq)."""
        if n % self.seq:
            raise ValueError(f"sequence length {n} does not divide into "
                             f"{self.seq} shards")
        local = n // self.seq
        return slice(self.seq_index * local, (self.seq_index + 1) * local)


def init_grid(data: int, seq: int, backend: str | None = None, *,
              timeout: float | None = None) -> Grid:
    """Join the process group (unless joined already) and build the grid.

    Reads the usual ``torch.distributed`` environment: RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT. ``backend``: "nccl" or "gloo"; by default
    "nccl" where a card is present, else "gloo". Several ranks that share
    one card need "gloo" (NCCL puts one rank on a card). ``timeout``
    (seconds) bounds every collective of the group. Every rank makes the
    same calls, in the same order, as ``dist.new_group`` requires."""
    if data < 1 or seq < 1:
        raise ValueError(f"grid ({data}, {seq}) must be positive")
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(backend, init_method="env://", **kw)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * seq:
        raise ValueError(f"world size {world} is not data {data} x seq "
                         f"{seq} (WORLD_SIZE={os.environ.get('WORLD_SIZE')})")
    data_index, seq_index = divmod(rank, seq)
    seq_group = data_group = None
    for d in range(data):  # every rank creates every group, in order
        g = dist.new_group([d * seq + s for s in range(seq)])
        if d == data_index:
            seq_group = g
    for s in range(seq):
        g = dist.new_group([d * seq + s for d in range(data)])
        if s == seq_index:
            data_group = g
    return Grid(data=data, seq=seq, rank=rank, data_index=data_index,
                seq_index=seq_index, world_group=dist.group.WORLD,
                data_group=data_group, seq_group=seq_group)


def shard_batch(batch: torch.Tensor, grid: Grid) -> torch.Tensor:
    """This rank's rows of a global batch ``(..., rows, seq_len + 1)``:
    rows ``[data_index * rows / data, ...)``, each whole. A rank needs the
    whole token row even where it computes only its positions, because
    the loss mask of a sequence (non-pad plus the first pad) depends on
    all of it; the model and the loss take the rank's positions."""
    rows = batch.shape[-2]
    if rows % grid.data:
        raise ValueError(f"{rows} batch rows do not divide over data "
                         f"{grid.data}")
    local = rows // grid.data
    return batch[..., grid.data_index * local:(grid.data_index + 1) * local,
                 :]
