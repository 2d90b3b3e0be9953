"""Weight bridge between a flax parameter tree and the port's state_dict.

Works on numpy trees, so it needs neither JAX nor flax: a flax checkpoint
restored to numpy (``jax.tree.map(np.asarray, params)``) loads into
``ProGen.load_state_dict(flax_params_to_state_dict(tree, config))``, and
``state_dict_to_flax_params`` writes the tree back.

Layouts: a flax ``Dense`` kernel is (in, out) and the port's weight
(out, in), so kernels are transposed; the fused ``to_qkv`` keeps its
q | k | v feature order, each (heads, dim_head), through the transpose.
A ``scan_layers`` tree stacks the uniform layers under ``layers``; it is
unstacked here (and stacked on the way back) in numpy. Every leaf is
copied exactly and keeps its dtype (float32, or bfloat16 for a model
built with ``param_dtype = "bfloat16"``; numpy holds bfloat16 as
``ml_dtypes.bfloat16``), so a round trip is bit-equal.

The optimizer state crosses the same way: optax's Adam ``count``, ``mu``
and ``nu`` (``ScaleByAdamState``, wherever it sits in the chain's state)
go through the params' leaf map and transposes into the port's
``MaskedAdamW.state_dict()`` form, and back as a plain
``{"count", "mu", "nu"}`` tree of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from progen_tpu_torch.config import ProGenConfig

_NORM = ("ScaleNorm_0", "norm", "scale")


def _layer_leaves(config: ProGenConfig, i: int):
    """(flax path under the layer, port key suffix, transposed) for the
    attention block ``attn{i}`` and the feed-forward block ``ff{i}``."""
    use_gmlp = (config.depth - i) <= config.global_mlp_depth
    attn = [
        (_NORM, "norm.scale", False),
        (("to_qkv", "kernel"), "to_qkv.weight", True),
        (("to_out", "kernel"), "to_out.weight", True),
        (("to_out", "bias"), "to_out.bias", False),
    ]
    ff = [
        (_NORM, "norm.scale", False),
        (("proj_in", "kernel"), "proj_in.weight", True),
        (("proj_in", "bias"), "proj_in.bias", False),
        (("proj_out", "kernel"), "proj_out.weight", True),
        (("proj_out", "bias"), "proj_out.bias", False),
    ]
    if use_gmlp:
        ff += [
            (("sgu",) + _NORM, "sgu.norm.scale", False),
            (("sgu", "spatial_weights"), "sgu.spatial_weights", False),
            (("sgu", "spatial_biases"), "sgu.spatial_biases", False),
            (("sgu", "proj_out", "kernel"), "sgu.proj_out.weight", True),
            (("sgu", "proj_out", "bias"), "sgu.proj_out.bias", False),
        ]
    return attn, ff


_TOP = [
    (("embed", "embedding"), "embed", False),
    (_NORM, "norm.scale", False),
    (("to_logits", "kernel"), "to_logits.weight", True),
    (("to_logits", "bias"), "to_logits.bias", False),
]


def _get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype and bits (numpy's
    bfloat16 goes through its 16-bit pattern, which torch cannot read
    directly)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of ``_to_torch``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _n_uniform(config: ProGenConfig) -> int:
    return config.depth - config.global_mlp_depth


def _unstack(tree: dict, config: ProGenConfig) -> dict:
    """A scan_layers tree -> the unrolled attn{i}/ff{i} layout."""
    if "layers" not in tree:
        return tree
    out = {k: v for k, v in tree.items() if k != "layers"}

    def take(sub, i):
        if isinstance(sub, dict):
            return {k: take(v, i) for k, v in sub.items()}
        return np.asarray(sub)[i]

    for i in range(_n_uniform(config)):
        out[f"attn{i}"] = take(tree["layers"]["attn"], i)
        out[f"ff{i}"] = take(tree["layers"]["ff"], i)
    return out


def _stack(tree: dict, config: ProGenConfig) -> dict:
    """The unrolled layout -> a scan_layers tree."""
    n = _n_uniform(config)
    if n < 1:
        return tree
    names = {f"{p}{i}" for p in ("attn", "ff") for i in range(n)}
    out = {k: v for k, v in tree.items() if k not in names}

    def stack(*subs):
        if isinstance(subs[0], dict):
            return {k: stack(*(s[k] for s in subs)) for k in subs[0]}
        return np.stack(subs)

    out["layers"] = {
        "attn": stack(*(tree[f"attn{i}"] for i in range(n))),
        "ff": stack(*(tree[f"ff{i}"] for i in range(n))),
    }
    return out


def _leaves(config: ProGenConfig):
    """(flax path, port key, transposed) for every parameter."""
    yield from _TOP
    for i in range(config.depth):
        attn, ff = _layer_leaves(config, i)
        for path, key, t in attn:
            yield (f"attn{i}",) + path, f"attn.{i}.{key}", t
        for path, key, t in ff:
            yield (f"ff{i}",) + path, f"ff.{i}.{key}", t


def flax_params_to_state_dict(tree: dict,
                              config: ProGenConfig) -> dict[str, torch.Tensor]:
    """A flax params tree of numpy arrays (stacked or unrolled) -> the
    port's state_dict of CPU tensors in the tree's dtypes."""
    tree = _unstack(tree, config)
    sd = {}
    for path, key, transposed in _leaves(config):
        a = _get(tree, path)
        sd[key] = _to_torch(a.T if transposed else a)
    return sd


def state_dict_to_flax_params(sd: dict, config: ProGenConfig,
                              scan_layers: bool | None = None) -> dict:
    """The port's state_dict -> a flax params tree of numpy arrays,
    stacked under ``layers`` when ``scan_layers`` (default: the
    config's)."""
    tree: dict = {}
    for path, key, transposed in _leaves(config):
        a = _to_numpy(sd[key])
        _set(tree, path, np.ascontiguousarray(a.T if transposed else a))
    if config.scan_layers if scan_layers is None else scan_layers:
        tree = _stack(tree, config)
    return tree


_ADAM = {"count", "mu", "nu"}


def _adam_node(opt_state) -> dict:
    """count, mu and nu of the two layouts that exist: a plain dict of
    those keys, or the JAX package's ``chain(clip_by_global_norm, adamw)``
    state, whose ScaleByAdamState sits at ``opt_state[1][0]``."""
    if isinstance(opt_state, dict) and _ADAM <= opt_state.keys():
        return opt_state
    try:
        adam = opt_state[1][0]
    except (TypeError, IndexError, KeyError):
        adam = None
    if _ADAM <= set(getattr(adam, "_fields", ())):
        return adam._asdict()
    raise ValueError("no Adam state (count, mu, nu): expected a dict of "
                     "those keys or a chain(clip, adamw) state")


def flax_opt_state_to_torch(opt_state, config: ProGenConfig) -> dict:
    """An optax optimizer state of numpy arrays (the JAX package's
    ``chain(clip_by_global_norm, adamw)`` state, or a plain ``{"count",
    "mu", "nu"}`` tree) -> ``{"count": int, "mu": state_dict, "nu":
    state_dict}`` of CPU tensors in the tree's dtypes, for
    ``MaskedAdamW.load_state_dict``."""
    adam = _adam_node(opt_state)
    return {"count": int(np.asarray(adam["count"])),
            "mu": flax_params_to_state_dict(adam["mu"], config),
            "nu": flax_params_to_state_dict(adam["nu"], config)}


def torch_opt_state_to_flax(state: dict, config: ProGenConfig,
                            scan_layers: bool | None = None) -> dict:
    """``MaskedAdamW.state_dict()`` -> ``{"count": int32, "mu": tree,
    "nu": tree}`` of numpy arrays, the trees laid out as
    ``state_dict_to_flax_params`` lays out the params."""
    return {"count": np.asarray(state["count"], dtype=np.int32),
            "mu": state_dict_to_flax_params(state["mu"], config,
                                            scan_layers),
            "nu": state_dict_to_flax_params(state["nu"], config,
                                            scan_layers)}
