"""ProGen (lucidrains/progen's architecture, as the program runs it): its
sizes, its seeded weights' kinds, its hand-written kernels and their
work, and its plain reference.

``flops_per_token`` is a copy of ``progen_tpu_torch/profiling.py``'s;
the bytes and operations of each kernel are copies of the arithmetic
behind ``chip_smoke.py``'s kernel table (its ``bound ms`` column). They
live here so that a change to the program cannot change what it is
measured against.

A kernel's work is counted from the shapes and the number of calls a
step needs, never from its launches: the same work is charged whatever
runs it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from portbench import counts, spec as specs
from portbench.reference import progen as plain


@dataclasses.dataclass(frozen=True)
class Spec:
    num_tokens: int
    dim: int
    depth: int
    heads: int
    dim_head: int
    window_size: int
    seq_len: int
    global_mlp_depth: int
    ff_mult: int
    ff_glu: bool
    shift_tokens: bool
    rotate_value: bool
    layer_norm_epsilon: float
    remat: bool
    dtype: str
    param_dtype: str

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        missing = names - d.keys()
        if missing:
            raise ValueError(f"configuration lacks {sorted(missing)}")
        return cls(**{k: d[k] for k in names})

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    def is_gmlp(self, layer: int) -> bool:
        return self.depth - layer <= self.global_mlp_depth

    def parameter_shapes(self) -> list:
        """(name, shape, kind) of every parameter, in the program's
        ``named_parameters`` order. ``kind`` says how ``weights.make``
        draws it."""
        d, n = self.dim, self.seq_len
        out = [("embed", (self.num_tokens, d), "embed")]
        for i in range(self.depth):
            a = f"attn.{i}."
            out += [(a + "norm.scale", (d,), "scale"),
                    (a + "to_qkv.weight", (3 * self.inner_dim, d), "dense"),
                    (a + "to_out.weight", (d, self.inner_dim), "dense"),
                    (a + "to_out.bias", (d,), "bias")]
        for i in range(self.depth):
            f = f"ff.{i}."
            gmlp = self.is_gmlp(i)
            glu = self.ff_glu and not gmlp
            hidden = d * self.ff_mult * (2 if glu else 1)
            inner = hidden // 2 if (glu or gmlp) else hidden
            out += [(f + "norm.scale", (d,), "scale"),
                    (f + "proj_in.weight", (hidden, d), "dense"),
                    (f + "proj_in.bias", (hidden,), "bias")]
            if gmlp:
                half = hidden // 2
                s = f + "sgu."
                out += [(s + "norm.scale", (half,), "scale"),
                        (s + "spatial_weights", (n, n), "spatial"),
                        (s + "spatial_biases", (n, 1), "spatial_bias"),
                        (s + "proj_out.weight", (half, half), "dense"),
                        (s + "proj_out.bias", (half,), "bias")]
            out += [(f + "proj_out.weight", (d, inner), "dense"),
                    (f + "proj_out.bias", (d,), "bias")]
        out += [("norm.scale", (d,), "scale"),
                ("to_logits.weight", (self.num_tokens, d), "dense"),
                ("to_logits.bias", (self.num_tokens,), "bias")]
        return out

    def num_params(self) -> int:
        return sum(math.prod(shape) for _, shape, _ in
                   self.parameter_shapes())


# The scale of a model in use rather than of a fresh init, so that every
# layer shapes the output: dense weights N(0, 1/fan_in), the embedding
# and biases N(0, 0.02^2), norm scales 1 + N(0, 0.1^2), the SGU's
# spatial mix N(0, 1/n) (an init at +-1e-3/n would leave the mix, and so
# kernel L2, out of every output) and its biases 1 + N(0, 0.1^2).
SCALES = {"embed": (lambda shape, spec: 0.02, 0.0),
          "dense": (lambda shape, spec: 1.0 / math.sqrt(shape[1]), 0.0),
          "bias": (lambda shape, spec: 0.02, 0.0),
          "scale": (lambda shape, spec: 0.1, 1.0),
          "spatial": (lambda shape, spec: 1.0 / math.sqrt(spec.seq_len),
                      0.0),
          "spatial_bias": (lambda shape, spec: 0.1, 1.0)}

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


# the plain float32 reference (``reference/progen.py``)
rows_nll = plain.rows_nll


def flops_per_token(spec: Spec) -> int:
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


def kernel_bounds(spec: Spec, rows: int) -> dict:
    """Kernel id -> ``counts.bound_ms`` of one call over ``rows``
    sequences of the whole length, in the configuration's compute
    dtype."""
    dt = spec.dtype
    es = counts.ESIZE[dt]
    n, w, d = spec.seq_len, spec.window_size, spec.dim_head
    bh = rows * spec.heads
    pairs = counts.visible_pairs(n, w) * bh
    half = spec.dim * spec.ff_mult // 2
    x = rows * n * spec.dim
    return {
        # q, k, v read and out written once; S and P.V over visible pairs
        "A1": counts.bound_ms(4 * bh * n * d * es, 2 * 2 * d * pairs, dt),
        # q, k, v, dO read, dq, dk, dv written; S, dP, dV, dQ, dK
        "A2": counts.bound_ms(7 * bh * n * d * es, 5 * 2 * d * pairs, dt),
        # the row read, the row written, the float32 scale
        "L1": counts.bound_ms(2 * x * es + 4 * spec.dim, 7 * x, dt),
        # x, gate read, out written; float32 W, biases and scale; the
        # causal mix's products on the tensor cores in bfloat16, on the
        # FMA units otherwise
        "L2": counts.bound_ms(
            3 * rows * n * half * es + 4 * (n * n + n + half),
            2 * rows * half * n * (n + 1) // 2,
            dt if dt == "bfloat16" else "float32"),
    }


def kernel_calls(spec: Spec, *, forwards: int, backwards: int) -> dict:
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


def work_ms(spec: Spec, rows: int, *, forwards: int, backwards: int) -> dict:
    """Kernel id -> the least time of that kernel's work, in ms, for
    the given passes over ``rows`` sequences."""
    bounds = kernel_bounds(spec, rows)
    calls = kernel_calls(spec, forwards=forwards, backwards=backwards)
    return {rid: calls[rid] * bounds[rid]["bound_ms"] for rid in calls}


def train_step_passes(spec: Spec, grad_accum: int) -> dict:
    """The passes of one optimizer step: each micro-batch runs a
    forward, with remat a second one in the backward, and a backward."""
    return dict(forwards=grad_accum * (2 if spec.remat else 1),
                backwards=grad_accum)


def program_train_state(raw: dict, optimizer, device):
    """The program's training state for the configuration ``raw``, with
    the program's ``OptimizerConfig`` ``optimizer``; its parameters are
    left for ``load_state_dict``."""
    from progen_tpu_torch.config import ProGenConfig
    from progen_tpu_torch.training.step import init_train_state

    config = ProGenConfig.from_dict(specs.program_dict(raw))
    with torch.device(device):
        return init_train_state(config, optimizer, seed=None, device=device)
