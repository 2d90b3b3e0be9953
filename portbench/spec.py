"""A model configuration as the yardstick reads it: the sizes of
``configs/<name>.json``, independent of the program's own config class,
and the parameters those sizes imply, named as the program's
``state_dict`` names them."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

# the keys of a configuration file that are not sizes of the model
META_KEYS = ("name", "source", "derived_from", "reduced", "assumed",
             "assumed_why")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
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
    def from_dict(cls, d: dict) -> "ModelSpec":
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
        total = 0
        for _, shape, _ in self.parameter_shapes():
            k = 1
            for s in shape:
                k *= s
            total += k
        return total


def load_config(path: Path) -> tuple[dict, ModelSpec]:
    """The configuration file's whole object and its sizes."""
    raw = json.loads(Path(path).read_text())
    return raw, ModelSpec.from_dict(raw)


def program_dict(raw: dict) -> dict:
    """The sizes to hand the program's config class: the file without
    its descriptive keys."""
    return {k: v for k, v in raw.items() if k not in META_KEYS}
