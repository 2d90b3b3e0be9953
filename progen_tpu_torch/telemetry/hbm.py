"""Device-memory gauges from the CUDA caching allocator.

The port's counterpart of the JAX package's ``telemetry/hbm.py``, with
its names: ``in_use_gb`` (``torch.cuda.memory_allocated``), ``peak_gb``
(``torch.cuda.max_memory_allocated``), ``limit_gb`` (the card's total
memory, ``torch.cuda.mem_get_info()[1]``) and ``used_pct``. The JAX
module's ``largest_alloc_gb`` has no counterpart in the caching
allocator and is left out. None of these calls synchronises the device:
the allocator's counters are host-side, and ``mem_get_info`` queries the
CUDA runtime, not the stream. On a CPU device, or without a card, the result
is ``{}``, as the JAX module's is on a backend without memory stats, so
callers can always splat it into a metrics dict.
"""

from __future__ import annotations

import torch


def hbm_gauges(device=None, prefix: str = "hbm/") -> dict:
    """Flat gauge dict (GB, rounded) for ``device`` (default: the current
    card). Empty on a CPU device or when no card is present."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return {}
    try:
        in_use = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        limit = torch.cuda.mem_get_info(dev)[1]
    except (RuntimeError, AssertionError):
        return {}

    def _gb(v: int) -> float:
        return round(v / 2**30, 3)

    out = {f"{prefix}in_use_gb": _gb(in_use), f"{prefix}peak_gb": _gb(peak),
           f"{prefix}limit_gb": _gb(limit)}
    if limit:
        out[f"{prefix}used_pct"] = round(100.0 * in_use / limit, 2)
    return out
