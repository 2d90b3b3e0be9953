"""A toy family of another architecture than ProGen's, for the tests: a
small causal language model whose layers alternate, as its
``layer_types`` say, between a dense feed-forward and a top-1 mixture of
experts behind a router. Its program side is the plain module
``ToyLM`` below, trained by the program's own train step and optimizer.

``test_portbench_discovery.py`` copies this file as ``families/toy.py``
into a copy of ``portbench/`` to show that a family joins the benchmark
by new files alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench import counts


@dataclasses.dataclass(frozen=True)
class Spec:
    num_tokens: int
    dim: int
    heads: int
    dim_head: int
    seq_len: int
    experts: int
    layer_types: tuple  # "dense" or "moe", one a layer
    remat: bool
    dtype: str

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        names = {f.name for f in dataclasses.fields(cls)}
        missing = names - d.keys()
        if missing:
            raise ValueError(f"configuration lacks {sorted(missing)}")
        return cls(**{k: (tuple(d[k]) if k == "layer_types" else d[k])
                      for k in names})

    def parameter_shapes(self) -> list:
        d, inner = self.dim, self.heads * self.dim_head
        out = [("embed", (self.num_tokens, d), "embed")]
        for i, kind in enumerate(self.layer_types):
            out += [(f"l{i}_attn_norm", (d,), "scale"),
                    (f"l{i}_qkv", (3 * inner, d), "dense"),
                    (f"l{i}_out", (d, inner), "dense"),
                    (f"l{i}_ff_norm", (d,), "scale")]
            if kind == "moe":
                out += [(f"l{i}_router", (self.experts, d), "router"),
                        (f"l{i}_experts_in", (self.experts, 2 * d, d),
                         "experts"),
                        (f"l{i}_experts_out", (self.experts, d, 2 * d),
                         "experts")]
            else:
                out += [(f"l{i}_ff_in", (4 * d, d), "dense"),
                        (f"l{i}_ff_out", (d, 4 * d), "dense")]
        out += [("norm", (d,), "scale"),
                ("to_logits", (self.num_tokens, d), "dense")]
        return out

    def num_params(self) -> int:
        return sum(math.prod(s) for _, s, _ in self.parameter_shapes())


SCALES = {"embed": (lambda shape, spec: 0.02, 0.0),
          "dense": (lambda shape, spec: 1.0 / math.sqrt(shape[1]), 0.0),
          "scale": (lambda shape, spec: 0.1, 1.0),
          "router": (lambda shape, spec: 1.0 / math.sqrt(spec.dim), 0.0),
          "experts": (lambda shape, spec: 1.0 / math.sqrt(shape[2]), 0.0)}

KERNEL_NAMES = {"X1": ("toy_router_kernel",)}


def _moe_layers(spec: Spec) -> int:
    return sum(kind == "moe" for kind in spec.layer_types)


def flops_per_token(spec: Spec) -> int:
    """6 x the parameters a token uses (one expert of each mixture) and
    the causal attention's products over the mean context n / 2."""
    idle = (spec.experts - 1) * 4 * spec.dim * spec.dim * _moe_layers(spec)
    attn = 12 * len(spec.layer_types) * spec.heads * spec.dim_head
    return 6 * (spec.num_params() - idle) + attn * spec.seq_len // 2


def work_ms(spec: Spec, rows: int, *, forwards: int, backwards: int) -> dict:
    """The router's kernel X1, once a mixture a forward: the rows read
    once and the router's weights, its products over every expert."""
    es = counts.ESIZE[spec.dtype]
    x = rows * spec.seq_len * spec.dim
    one = counts.bound_ms(x * es + spec.experts * spec.dim * es,
                          2 * x * spec.experts, spec.dtype)
    return {"X1": forwards * _moe_layers(spec) * one["bound_ms"]}


def train_step_passes(spec: Spec, grad_accum: int) -> dict:
    return dict(forwards=grad_accum, backwards=grad_accum)


def _norm(x, scale):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def logits(P: dict, spec: Spec, ids: torch.Tensor, linear=F.linear):
    """ids (b, n) -> float32 logits (b, n, num_tokens)."""
    b, n = ids.shape
    x = P["embed"][ids]
    for i, kind in enumerate(spec.layer_types):
        h = _norm(x, P[f"l{i}_attn_norm"])
        q, k, v = (t.reshape(b, n, spec.heads, spec.dim_head).transpose(1, 2)
                   for t in linear(h, P[f"l{i}_qkv"], None).chunk(3, -1))
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + linear(a.transpose(1, 2).reshape(b, n, -1), P[f"l{i}_out"],
                       None)
        h = _norm(x, P[f"l{i}_ff_norm"])
        if kind == "moe":
            gate = torch.softmax(linear(h, P[f"l{i}_router"], None), -1)
            weight, pick = gate.max(dim=-1)
            y = torch.zeros_like(h)
            for e in range(spec.experts):
                out = linear(F.gelu(linear(h, P[f"l{i}_experts_in"][e], None)),
                             P[f"l{i}_experts_out"][e], None)
                y = y + ((pick == e) * weight)[..., None] * out
            x = x + y
        else:
            x = x + linear(F.gelu(linear(h, P[f"l{i}_ff_in"], None)),
                           P[f"l{i}_ff_out"], None)
    return linear(_norm(x, P["norm"]), P["to_logits"], None)


def rows_nll(P: dict, spec: Spec, rows: torch.Tensor, linear=F.linear):
    """rows (b, n + 1) -> (b,) per-sequence loss over each sequence's
    tokens and its first pad (the EOS)."""
    targets = rows[:, 1:]
    nll = -torch.log_softmax(logits(P, spec, rows[:, :-1], linear),
                             -1).gather(-1, targets[..., None])[..., 0]
    pad = targets == 0
    keep = (~pad | (pad.long().cumsum(-1) == 1)).to(nll.dtype)
    return (nll * keep).sum(-1) / keep.sum(-1)


class ToyLM(nn.Module):
    """The program side: the model as a module the program's train step
    drives (``model(ids, grid)``, ``.tp``, ``.device``)."""

    tp = None

    def __init__(self, spec: Spec, device):
        super().__init__()
        self.spec, self.device = spec, torch.device(device)
        for name, shape, _ in spec.parameter_shapes():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device=device)))

    def forward(self, ids, grid=None):
        return logits(dict(self.named_parameters()), self.spec, ids)


def program_train_state(raw: dict, optimizer, device):
    from progen_tpu_torch.training.optimizer import MaskedAdamW
    from progen_tpu_torch.training.state import TrainState

    model = ToyLM(Spec.from_dict(raw), device)
    return TrainState(step=0, model=model,
                      optimizer=MaskedAdamW(model, optimizer))
