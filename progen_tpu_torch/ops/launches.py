"""The kernel wrappers' launch counts, by kernel id.

Each wrapper adds one to its own ``launches`` where it launches its CUDA
kernel (never on the plain version's CPU path), so a process can say
which kernels its work went through: ``cli.serve`` writes the counts
into its exposition as ``progen_serve_kernel_launches_<id>`` gauges.
"""

from __future__ import annotations

from progen_tpu_torch.ops import cuda_attention, cuda_layers

WRAPPERS = {"A1": cuda_attention.local_attention_fwd,
            "A2": cuda_attention.local_attention_bwd_kv,
            "A3": cuda_attention.local_attention_bwd_halo,
            "A4-fwd": cuda_attention.local_attention_halo_fwd,
            "A4-kv": cuda_attention.local_attention_halo_bwd_kv,
            "A4-halo": cuda_attention.local_attention_halo_bwd_halo,
            "L1": cuda_layers.norm_shift,
            "L2": cuda_layers.sgu_mix_gate}


def launch_counts() -> dict:
    """Kernel id -> launches in this process since the last reset."""
    return {rid: fn.launches for rid, fn in WRAPPERS.items()}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def gauge_name(rid: str) -> str:
    """A kernel id's gauge: ``kernel_launches_a4_fwd`` for A4-fwd."""
    return "kernel_launches_" + rid.lower().replace("-", "_")
