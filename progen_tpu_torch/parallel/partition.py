"""ZeRO-1: the optimizer's moments cut over the data group.

Counterpart of ``zero1_opt_shardings`` (``progen_tpu/parallel/
partition.py:310-355``). Each moment tensor is cut over the data group
on its LARGEST dimension that the tensor-parallel layout leaves whole
and that the data size divides; a tensor with no such dimension keeps
its moments whole, as in the reference. The parameters and their
gradients keep their layout, so the forward and backward are untouched:
each rank updates its slice of the moments and of the parameters (the
update is elementwise, so the parameters come out bit-equal to the same
grid without ZeRO-1) and the slices are then all-gathered.

The reference's GSPMD turns the gradient all-reduce plus the sliced
update into a reduce-scatter; here the gradients are all-reduced whole
(gloo carries only all_gather, all_reduce and broadcast for CUDA
tensors) and each rank takes its slice, so the global norm, the clip and
the finite gate see the same values as without ZeRO-1. A reduce-scatter
over NCCL is later work. Where the reference leaves the model axis of a
size-1 mesh out of the free dimensions, this port counts a dimension as
cut only where the model axis is above 1.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from progen_tpu_torch.parallel.collectives import _all_gather


def zero1_dim(shape, tp_dim: int | None, data: int) -> int | None:
    """The dimension a moment of ``shape`` is cut on over ``data`` ranks:
    the largest that is not ``tp_dim`` (cut over the model group) and
    that ``data`` divides; None when there is none."""
    free = [i for i, n in enumerate(shape)
            if i != tp_dim and n > 0 and n % data == 0]
    if data == 1 or not free:
        return None
    return max(free, key=lambda i: shape[i])


@dataclasses.dataclass(frozen=True)
class Zero1:
    """This rank's place in the data group that the moments are cut
    over."""

    group: dist.ProcessGroup
    size: int
    index: int

    @classmethod
    def of(cls, grid) -> "Zero1 | None":
        if grid is None or grid.data == 1:
            return None
        return cls(grid.data_group, grid.data, grid.data_index)

    def __deepcopy__(self, memo) -> "Zero1":
        return self  # a copied optimizer keeps its place in the group

    def slice(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (a view); ``t`` when
        ``dim`` is None."""
        if dim is None:
            return t
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def gather_(self, tensors, dims) -> None:
        """In place: each whole tensor of ``tensors`` receives every
        rank's slice along its dim (``dims``; None: left as it is), in
        one all_gather of the slices packed together."""
        cut = [(t, d) for t, d in zip(tensors, dims) if d is not None]
        if not cut:
            return
        mine = torch.cat([self.slice(t, d).reshape(-1) for t, d in cut])
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        offset = 0
        for t, d in cut:
            piece = self.slice(t, d)
            n = piece.numel()
            for r, flat in enumerate(parts):
                dst = t.narrow(d, r * piece.shape[d], piece.shape[d])
                dst.copy_(flat[offset:offset + n].view(piece.shape))
            offset += n

    def gather(self, t: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The whole tensor from every rank's slice ``t`` (cut on
        ``dim``)."""
        if dim is None:
            return t
        return torch.cat(_all_gather(t, self.group), dim)
