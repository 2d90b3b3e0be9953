"""Data-, sequence- and tensor-parallel training, ZeRO-1 and the
pipelines, on ``torch.distributed``.

Counterpart of ``progen_tpu/parallel/``: the process grid and the
multi-process bootstrap (``groups.py``), the collectives the
sequence-sharded model runs as autograd functions (``collectives.py``),
the ring-halo local attention (``ring_attention.py``), the Megatron form
of the tensor-parallel rule table (``tensor.py``), ZeRO-1
(``partition.py``), and the GPipe and 1F1B pipelines over the model axis
(``pipeline.py``, ``pipeline_1f1b.py``).
"""

from progen_tpu_torch.parallel.groups import (
    Grid,
    init_grid,
    initialize_distributed,
    is_coordinator,
    shard_batch,
)

__all__ = ["Grid", "init_grid", "initialize_distributed", "is_coordinator",
           "shard_batch"]
