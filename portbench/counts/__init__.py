"""The yardstick's shared arithmetic, frozen: the card's peaks, the least
time of a kernel's work, and the shares of a roofline and of the peak.
What is one architecture's (FLOPs per position, each kernel's bytes,
operations and calls, its profiler names) is its family's
(``families/``).

``PEAK_BF16_FLOPS`` is a copy of ``progen_tpu_torch/profiling.py``'s;
``bound_ms`` and ``visible_pairs`` are copies of the arithmetic behind
``chip_smoke.py``'s kernel table (its ``bound ms`` column). They live
here so that a change to the program cannot change what it is measured
against.
"""

from __future__ import annotations

import re

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
# dense tensor-core rates (bf16, fp16) and the float32 FMA rate, FLOP/s
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# dense bfloat16 peak by a substring of torch.cuda.get_device_name(), the
# most specific names first; the SXM figure is the data sheet's at 700 W
PEAK_BF16_FLOPS = (("H100 PCIe", 756e12), ("H100", 989e12))
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def kernel_matcher(kernel_names: dict):
    """A function giving the id, in ``kernel_names`` (a family's
    ``KERNEL_NAMES``), of the hand-written kernel a profiler kernel name
    belongs to, or None for any other kernel."""
    id_of = {n: rid for rid, names in kernel_names.items() for n in names}
    pattern = re.compile(
        r"(?:^|[\s:])(" + "|".join(sorted(id_of, key=len, reverse=True))
        + r")\s*[<(]")

    def kernel_id(name: str) -> str | None:
        m = pattern.search(name)
        return id_of[m.group(1)] if m else None

    return kernel_id


def peak_flops(device_name: str) -> float | None:
    """The dense bfloat16 peak of a card by its name; None when the card
    is not in the table (no card's peak stands in for another's)."""
    for key, val in PEAK_BF16_FLOPS:
        if key.lower() in device_name.lower():
            return val
    return None


def bound_ms(nbytes: float, ops: float, dtype: str) -> dict:
    """The least time of a kernel's work: its bytes moved once over the
    memory rate, or its operations over the peak rate of their type,
    whichever is longer, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, bytes=nbytes)


def visible_pairs(n: int, w: int, halo: bool = False) -> int:
    """(query, key) pairs of one head's local attention that a query
    sees: its own window up to itself, and the whole previous window.
    Window 0's phantom zero keys are left out: they add nothing to any
    product. With a halo, window 0's previous window is real."""
    return sum((w if r >= w or halo else 0) + (r % w) + 1 for r in range(n))


def traced_work(family, spec, passes: dict) -> dict:
    """Kernel id -> the least time (ms) of the family's hand-written
    kernels' work in the traced ``passes`` (rows, forwards,
    backwards)."""
    return family.work_ms(spec, passes["rows"],
                          forwards=passes["forwards"],
                          backwards=passes["backwards"])


def kernels_roofline(work: dict, kernel_s: dict) -> float | None:
    """Percent: the least time of the hand-written kernels' ``work``
    (kernel id -> ms) over their device time there (kernel id -> s).
    None when a kernel that the work needs ran no time (it was removed
    or renamed, and its work is done by something the family's table
    does not know)."""
    needed = [rid for rid, ms in work.items() if ms > 0]
    if not needed or any(kernel_s.get(rid, 0.0) <= 0 for rid in needed):
        return None
    return 100.0 * sum(work.values()) / 1e3 / sum(kernel_s[r] for r in needed)


def mfu(flops_per_position: float, positions_per_s: float,
        device_name: str) -> float | None:
    """Percent of the card's dense bfloat16 peak; None for a card not in
    the table."""
    peak = peak_flops(device_name)
    if peak is None or positions_per_s <= 0:
        return None
    return 100.0 * flops_per_position * positions_per_s / peak
