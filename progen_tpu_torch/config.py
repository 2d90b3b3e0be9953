"""Model configuration for the PyTorch port.

Same fields, defaults, validation, dict round trip and closed-form
parameter count as ``progen_tpu/config.py``, so every
``configs/model/*.toml`` loads unchanged into either package.

The TPU knobs ``use_pallas_attn``, ``use_fused_layer_kernels``,
``pallas_bh_block``, ``pallas_layer_block`` and ``scan_layers`` are kept
so those files load, but on CUDA they select nothing: the port's
full-sequence forward always runs its hand-written kernels (local
attention, fused norm + token shift, fused SGU tail), so no plain version
runs on the card's main path. ``scan_layers`` only names the layout of a
flax checkpoint the weight bridge (``convert.py``) reads or writes.
``remat`` recomputes each block in the backward, as ``nn.remat`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ProGenConfig:
    num_tokens: int = 256
    dim: int = 512
    seq_len: int = 1024
    depth: int = 6
    window_size: int = 256
    global_mlp_depth: int = 2
    heads: int = 8
    dim_head: int = 64
    ff_mult: int = 4
    ff_glu: bool = True
    shift_tokens: bool = True
    # RoPE is applied to q, k and v, as in the reference model.
    rotate_value: bool = True
    sgu_init_eps: float = 1e-3
    layer_norm_epsilon: float = 1e-5
    # 0: dense causal SGU mix; > 0: block-triangular recursion (same math,
    # fewer products). The CUDA kernel skips the zero blocks either way.
    sgu_block_size: int = 0

    # Params live in ``param_dtype``, compute runs in ``dtype``, logits are
    # float32.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Kept so TPU configs load; see the module docstring.
    use_pallas_attn: bool = False
    pallas_bh_block: int = 0
    use_fused_layer_kernels: bool = False
    pallas_layer_block: int = 0
    use_ring_attn: bool = False
    remat: bool = False
    decode: bool = False
    scan_layers: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def params_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def inner_dim(self) -> int:
        return self.heads * self.dim_head

    def __post_init__(self):
        if self.seq_len % self.window_size != 0:
            raise ValueError(
                f"seq_len ({self.seq_len}) must be divisible by window_size "
                f"({self.window_size})"
            )

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ProGenConfig":
        """Build from a dict (e.g. parsed TOML), ignoring unknown keys."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def num_params(self) -> int:
        """Closed-form parameter count."""
        d, h = self.dim, self.ff_mult * self.dim
        n = self.num_tokens * d  # embed
        for i in range(self.depth):
            use_gmlp = (self.depth - i) <= self.global_mlp_depth
            use_glu = (not use_gmlp) and self.ff_glu
            # attention: norm scale + qkv + out proj (+bias)
            n += d + d * 3 * self.inner_dim + self.inner_dim * d + d
            hidden = h if use_gmlp else h * (2 if use_glu else 1)
            # ff: norm scale + proj_in (+bias)
            n += d + d * hidden + hidden
            if use_gmlp:
                half = hidden // 2
                # sgu: gate norm scale + spatial weights + biases + proj_out
                n += half + self.seq_len * self.seq_len + self.seq_len
                n += half * half + half
                n += half * d + d  # ff proj_out from half
            else:
                inner = hidden // 2 if use_glu else hidden
                n += inner * d + d
        n += d + d * self.num_tokens + self.num_tokens  # final norm + head
        return n


def load_toml_config(path: str) -> dict:
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)
