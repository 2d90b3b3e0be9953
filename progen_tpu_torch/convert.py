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

Tensor-parallel shards: ``shard_state_dict`` cuts the port's whole
state_dict (or moments keyed like it, or a whole train payload) into a
rank's shards by the rule table of ``parallel/tensor.py``, and
``gather_state_dict`` puts every rank's shards back together, bit for
bit: the rank's q | k | v heads and its columns of both GLU halves are
selected there and nowhere else.

Reference checkpoints (lucidrains/progen, the JAX package's
``convert.py``): one pickled dict ``{next_seq_index, params,
optim_state, model_config, run_id}`` whose ``params`` is a Haiku tree
keyed ``pro_gen_base/~/<module>``. ``reference_params_to_flax`` maps it
onto the flax tree (the JAX package's mapping, copied), and
``convert_checkpoint`` carries it through the bridge into a checkpoint
of the port's ``checkpoint.py`` that ``cli.train`` resumes and
``cli.sample``/``cli.batch_score``/``cli.scan``/``cli.serve`` load. The
weights, ``next_seq_index``, ``model_config`` and ``run_id`` carry
over; the reference's Adam moments do not (its optimizer chain differs
from the masked AdamW), so they start at zero, as in the JAX package.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from progen_tpu_torch.config import ProGenConfig
from progen_tpu_torch.parallel.tensor import layout, shard, unshard

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


def shard_state_dict(sd: dict, config: ProGenConfig, grid) -> dict:
    """Rank ``grid.model_index``'s tensor-parallel shards of a whole
    state_dict (``grid``: anything with ``model`` and ``model_index``).
    A train payload (``{"params", "optimizer": {"count", "mu", "nu"},
    "step"}``) is cut in its params and moments alike. The shards are
    copies that share no storage with ``sd``."""
    if "params" in sd:
        opt = sd["optimizer"]
        return {**sd, "params": shard_state_dict(sd["params"], config, grid),
                "optimizer": {**opt, **{k: shard_state_dict(opt[k], config,
                                                            grid)
                                        for k in ("mu", "nu")}}}
    return {n: shard(t, layout(n, config), grid.model,
                     grid.model_index).clone()
            for n, t in sd.items()}


def gather_state_dict(shards: list, config: ProGenConfig) -> dict:
    """The whole state_dict (or train payload) from every model rank's
    shards, in rank order: the inverse of ``shard_state_dict``."""
    first = shards[0]
    if "params" in first:
        opt = first["optimizer"]
        return {**first,
                "params": gather_state_dict([s["params"] for s in shards],
                                            config),
                "optimizer": {**opt, **{k: gather_state_dict(
                    [s["optimizer"][k] for s in shards], config)
                    for k in ("mu", "nu")}}}
    return {n: unshard([s[n] for s in shards], layout(n, config))
            for n in first}


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


def reference_params_to_flax(ref_params, depth: int) -> dict:
    """Map the reference's Haiku param tree into the flax tree.

    Orientations match throughout: Haiku's ``w`` is (in, out) like a
    flax kernel, and the SGU's spatial weights are (out_pos, in_pos) in
    both. Every leaf must be a numpy array: anything else (an unpickled
    jax array needs jax) raises ValueError."""
    prefix = "pro_gen_base/~"

    def g(mod: str, name: str) -> np.ndarray:
        leaf = ref_params[f"{prefix}/{mod}"][name]
        if not isinstance(leaf, np.ndarray):
            raise ValueError(
                f"reference leaf {prefix}/{mod}/{name} is a "
                f"{type(leaf).__module__}.{type(leaf).__name__}, not a numpy "
                "array: convert the checkpoint's params to numpy "
                "(jax.tree.map(np.asarray, params)) before progen_tpu_torch "
                "reads it")
        return leaf

    out = {
        "embed": {"embedding": g("embed", "embeddings")},
        "ScaleNorm_0": {"norm": {"scale": g("layer_norm", "scale")}},
        "to_logits": {"kernel": g("linear", "w"), "bias": g("linear", "b")},
    }
    for i in range(depth):
        out[f"attn{i}"] = {
            "ScaleNorm_0": {
                "norm": {"scale": g(f"attn{i}/~/layer_norm", "scale")}},
            "to_qkv": {"kernel": g(f"attn{i}/~/linear", "w")},
            "to_out": {"kernel": g(f"attn{i}/~/linear_1", "w"),
                       "bias": g(f"attn{i}/~/linear_1", "b")},
        }
        ff = {
            "ScaleNorm_0": {
                "norm": {"scale": g(f"ff{i}/~/layer_norm", "scale")}},
            "proj_in": {"kernel": g(f"ff{i}/~/linear", "w"),
                        "bias": g(f"ff{i}/~/linear", "b")},
            "proj_out": {"kernel": g(f"ff{i}/~/linear_1", "w"),
                         "bias": g(f"ff{i}/~/linear_1", "b")},
        }
        if f"{prefix}/ff{i}/~/sgu" in ref_params:
            ff["sgu"] = {
                "ScaleNorm_0": {
                    "norm": {"scale": g(f"ff{i}/~/sgu/~/layer_norm",
                                        "scale")}},
                "spatial_weights": g(f"ff{i}/~/sgu", "spatial_weights"),
                "spatial_biases": g(f"ff{i}/~/sgu", "spatial_biases"),
                "proj_out": {"kernel": g(f"ff{i}/~/sgu/~/linear", "w"),
                             "bias": g(f"ff{i}/~/sgu/~/linear", "b")},
            }
        out[f"ff{i}"] = ff
    return out


def load_reference_package(src: str) -> dict:
    """Read a reference ``ckpt_*.pkl`` with the standard library's pickle,
    as the JAX package does. Unpickling runs code named in the file, so
    read only checkpoints you trust. A pickle whose objects need a
    package this machine lacks (jax, haiku, optax) raises ValueError."""
    with open(src, "rb") as f:
        try:
            package = pickle.load(f)
        except ImportError as e:
            raise ValueError(
                f"{src}: the pickle holds objects of a package that is not "
                f"installed ({e}); progen_tpu_torch reads reference "
                "checkpoints whose leaves are numpy arrays") from e
    if not isinstance(package, dict) or not {"params", "model_config"} \
            <= package.keys():
        raise ValueError(f"{src}: not a reference checkpoint (a dict with "
                         "params and model_config)")
    return package


def convert_checkpoint(src: str, dest: str, *, device="cuda") -> str:
    """Read one reference ``ckpt_*.pkl`` and write a checkpoint of the
    port's format under ``dest``, building the model on ``device``.
    Returns the written checkpoint's directory."""
    from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
    from progen_tpu_torch.models.progen import ProGen
    from progen_tpu_torch.training.optimizer import (
        MaskedAdamW,
        OptimizerConfig,
    )
    from progen_tpu_torch.training.state import TrainState

    package = load_reference_package(src)
    config = ProGenConfig.from_dict(package["model_config"])
    tree = reference_params_to_flax(package["params"], config.depth)
    model = ProGen(config, device=device, seed=None)
    model.load_state_dict(flax_params_to_state_dict(tree, config))
    state = TrainState(0, model, MaskedAdamW(model, OptimizerConfig()))
    return get_checkpoint_fns(dest)[2](Package(
        next_seq_index=int(package.get("next_seq_index", 0)), state=state,
        model_config=config.to_dict(), run_id=package.get("run_id")))
