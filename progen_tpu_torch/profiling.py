"""Throughput observability: the port's copy of the JAX package's
``profiling.py``.

  * ``flops_per_token`` — PaLM-convention accounting, copied whole:
    6*params for the dense math (forward + backward) + 12*L*H*Dh*ctx for
    the attention score/value products, ctx = 2*window for this model's
    [prev|cur] windowed attention, with the SGU's spatial matrix charged
    by its true cost (see the function);
  * ``peak_flops`` — dense bfloat16 peak of an NVIDIA card by name, from
    the data sheets; an unknown card gives None, and then no MFU is
    reported (no card's peak stands in for another's);
  * ``StepTimer`` — wall clock per optimizer step -> tokens/s/card and
    MFU, with warm-up skipping so the first steps (the kernels' build and
    load) never pollute the numbers, and ``exclude`` for cadence work.

The train CLI's ``--profile_dir`` traces steps 2-4 with
``torch.profiler`` (``cli/train.py``).
"""

from __future__ import annotations

import time
from typing import Optional

# dense (no sparsity) bfloat16 tensor-core peak, FLOP/s, by a substring of
# torch.cuda.get_device_name(); the most specific names first. The H100
# SXM figure is the data sheet's at 700 W.
PEAK_BF16_FLOPS = (
    ("H100 PCIe", 756e12),  # before "H100", which its name contains
    ("H100", 989e12),
)


def flops_per_token(config) -> int:
    """Training FLOPs per token (fwd+bwd), PaLM MFU convention.

    The SGU's ``(n, n)`` spatial matrix is the one place the ``6*params``
    convention breaks: a per-sequence weight does ``2*n*d_half`` fwd flops
    per *token* (each output token mixes n sequence positions of a
    d_half-wide activation), not the ``2*n*n`` the convention would charge.
    They coincide only when ``d_half == n`` (the default config's
    1024/1024); at long context (n=8192, d_half=1024) the params convention
    overstates the SGU term 8x. So: charge ``6*(params - spatial)`` for the
    dense math and ``6*n*d_half`` per gMLP layer for the spatial mix.
    """
    attn_ctx = 2 * config.window_size
    n = config.seq_len
    d_half = (config.ff_mult * config.dim) // 2
    n_gmlp = min(config.global_mlp_depth, config.depth)
    spatial_params = n_gmlp * n * n
    return (
        6 * (config.num_params() - spatial_params)
        + n_gmlp * 6 * n * d_half
        + 12 * config.depth * config.heads * config.dim_head * attn_ctx
    )


def peak_flops(device) -> Optional[float]:
    """The dense bfloat16 peak of ``device`` (a ``torch.device``, a device
    string, or a card's name as ``torch.cuda.get_device_name`` gives it);
    None for a CPU device or a card not in ``PEAK_BF16_FLOPS``."""
    name = device
    if not isinstance(device, str) or device.split(":")[0] in ("cuda",
                                                                "cpu"):
        import torch

        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    for key, val in PEAK_BF16_FLOPS:
        if key.lower() in name.lower():
            return val
    return None


class StepTimer:
    """Tracks per-step wall time and derives throughput metrics.

    Call ``tick(tokens)`` once per optimizer step AFTER the step's result
    has been observed on the host (e.g. float(loss) — that sync is the
    timing fence). The first ``warmup`` ticks are discarded (the kernels'
    build and load). With ``peak`` None, no ``mfu`` is reported."""

    def __init__(self, n_chips: int, flops_per_tok: int,
                 peak: Optional[float], warmup: int = 2):
        self.n_chips = max(n_chips, 1)
        self.flops_per_tok = flops_per_tok
        self.peak = peak
        self.warmup = warmup
        self._last: Optional[float] = None
        self._steps = 0
        self._time = 0.0
        self._tokens = 0
        self._excluded = 0.0

    def exclude(self, seconds: float) -> None:
        """Subtract known non-step work (checkpoint/eval/sample between
        ticks) from the next ``tick``'s window, so cadence work does not
        inflate step_ms / deflate MFU."""
        self._excluded += max(seconds, 0.0)

    def tick(self, tokens: int) -> Optional[dict]:
        """Returns {step_ms, tokens_per_sec_per_chip[, mfu]} once
        measuring (post-warmup), else None."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            self._excluded = 0.0
            return None
        dt = max(now - self._last - self._excluded, 0.0)
        self._last, self._excluded = now, 0.0
        self._steps += 1
        if self._steps <= self.warmup:
            return None
        self._time += dt
        self._tokens += tokens
        per_chip = self._tokens / self._time / self.n_chips
        out = {"step_ms": 1000.0 * dt, "tokens_per_sec_per_chip": per_chip}
        if self.peak:
            out["mfu"] = per_chip * self.flops_per_tok / self.peak
        return out
