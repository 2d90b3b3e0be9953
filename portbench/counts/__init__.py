"""The yardstick's arithmetic, frozen: FLOPs per position, the card's
peaks, and the least time of each hand-written kernel's work.

``flops_per_token`` and ``PEAK_BF16_FLOPS`` are copies of
``progen_tpu_torch/profiling.py``'s; ``bound_ms``, ``visible_pairs`` and
the bytes and operations of each kernel are copies of the arithmetic
behind ``chip_smoke.py``'s kernel table (its ``bound ms`` column). They
live here so that a change to the program cannot change what it is
measured against.

A kernel's work is counted from the shapes and the number of calls a
step needs, never from its launches: the same work is charged whatever
runs it.
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

# profiler kernel names of each hand-written kernel, by the ids of
# PERF.md's kernel table. A2's group holds the row pass (dq) that its
# tensor-core path launches beside the key pass; A3 shares that row pass.
KERNEL_NAMES = {
    "A1": ("fwd_tc_kernel", "local_attention_fwd_kernel"),
    "A2": ("kv_tc_kernel", "kv_kernel", "rows_tc_kernel", "rows_kernel"),
    "A3": ("halo_tc_kernel", "halo_kernel"),
    "L1": ("norm_shift_kernel",),
    "L2": ("sgu_gate_stats", "sgu_gate_norm", "sgu_mix_kernel",
           "sgu_mix_tc_kernel"),
}
_PATTERN = re.compile(
    r"(?:^|[\s:])(" + "|".join(
        sorted({n for names in KERNEL_NAMES.values() for n in names},
               key=len, reverse=True)) + r")\s*[<(]")
_ID_OF = {n: rid for rid, names in KERNEL_NAMES.items() for n in names}


def kernel_id(name: str) -> str | None:
    """The id of the hand-written kernel a profiler kernel name belongs
    to, or None for any other kernel."""
    m = _PATTERN.search(name)
    return _ID_OF[m.group(1)] if m else None


def flops_per_token(spec) -> int:
    """Training FLOPs per position (forward + backward, no recompute),
    PaLM's convention: 6 x the parameters outside the SGU's (n, n)
    spatial matrices, 6 n d_half per gMLP layer for the spatial mix (its
    true cost per position), and 12 L H Dh ctx for the attention's two
    products with ctx = 2 x window."""
    attn_ctx = 2 * spec.window_size
    n = spec.seq_len
    d_half = (spec.ff_mult * spec.dim) // 2
    n_gmlp = min(spec.global_mlp_depth, spec.depth)
    spatial_params = n_gmlp * n * n
    return (6 * (spec.num_params() - spatial_params)
            + n_gmlp * 6 * n * d_half
            + 12 * spec.depth * spec.heads * spec.dim_head * attn_ctx)


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


def kernel_bounds(spec, rows: int) -> dict:
    """Kernel id -> ``bound_ms`` of one call over ``rows`` sequences of
    the whole length, in the configuration's compute dtype."""
    dt = spec.dtype
    es = ESIZE[dt]
    n, w, d = spec.seq_len, spec.window_size, spec.dim_head
    bh = rows * spec.heads
    pairs = visible_pairs(n, w) * bh
    half = spec.dim * spec.ff_mult // 2
    x = rows * n * spec.dim
    return {
        # q, k, v read and out written once; S and P.V over visible pairs
        "A1": bound_ms(4 * bh * n * d * es, 2 * 2 * d * pairs, dt),
        # q, k, v, dO read, dq, dk, dv written; S, dP, dV, dQ, dK
        "A2": bound_ms(7 * bh * n * d * es, 5 * 2 * d * pairs, dt),
        # the row read, the row written, the float32 scale
        "L1": bound_ms(2 * x * es + 4 * spec.dim, 7 * x, dt),
        # x, gate read, out written; float32 W, biases and scale; the
        # causal mix's products on the tensor cores in bfloat16, on the
        # FMA units otherwise
        "L2": bound_ms(3 * rows * n * half * es + 4 * (n * n + n + half),
                       2 * rows * half * n * (n + 1) // 2,
                       dt if dt == "bfloat16" else "float32"),
    }


def kernel_calls(spec, *, forwards: int, backwards: int) -> dict:
    """Kernel id -> calls for ``forwards`` full forwards (a remat
    recompute is a forward) and ``backwards`` backwards of the model.
    Each attention block runs A1 forward and A2 backward; each block
    head runs L1 (two a layer); each gMLP layer runs L2 forward. L1 and
    L2 have no backward kernel: their backward is the plain
    composition."""
    return {"A1": spec.depth * forwards,
            "A2": spec.depth * backwards,
            "L1": 2 * spec.depth * forwards,
            "L2": min(spec.global_mlp_depth, spec.depth) * forwards}


def work_ms(spec, rows: int, *, forwards: int, backwards: int) -> dict:
    """Kernel id -> the least time of that kernel's work, in ms, for
    the given passes over ``rows`` sequences."""
    bounds = kernel_bounds(spec, rows)
    calls = kernel_calls(spec, forwards=forwards, backwards=backwards)
    return {rid: calls[rid] * bounds[rid]["bound_ms"] for rid in calls}


def train_step_passes(spec, grad_accum: int) -> dict:
    """The passes of one optimizer step: each micro-batch runs a
    forward, with remat a second one in the backward, and a backward."""
    return dict(forwards=grad_accum * (2 if spec.remat else 1),
                backwards=grad_accum)


def kernels_roofline(spec, passes: dict, kernel_s: dict) -> float | None:
    """Percent: the least time of the hand-written kernels' work in the
    traced passes over their device time there. None when a kernel that
    the passes need ran no time (it was removed or renamed, and its work
    is done by something this table does not know)."""
    work = work_ms(spec, passes["rows"], forwards=passes["forwards"],
                   backwards=passes["backwards"])
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
