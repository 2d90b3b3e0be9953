"""A model built with ``param_dtype = "bfloat16"`` against the JAX
package's, at a small size on the CPU.

Config: the one of tests/test_torch_model.py and test_torch_train.py
(dim 64, depth 3 with 1 gMLP layer, heads 2, dim_head 16, window 8,
seq_len 32, ff_mult 2, vocab 32), with ``dtype`` and ``param_dtype``
bfloat16. Weights come from the JAX model's init, which draws every
parameter in bfloat16, with the SGU weights and biases and the norm
scales redrawn from numpy (so every parameter matters at this size) and
go to the port through ``convert.py``, which keeps their dtype.

Tolerances, each with its reason:
* parameters crossing the bridge: bit for bit, in bfloat16;
* logits to 0.1 absolute, as test_torch_model.py holds the bfloat16
  forward (a few bfloat16 ulps of logits of size ~3);
* one train step's loss to 1e-2 relative: a mean of bfloat16 logits'
  cross entropies that differ by those ulps;
* the Adam moments after the step (JAX's through
  ``convert.flax_opt_state_to_torch``) to 5% (mu) and 10% (nu) of each
  leaf's norm: mu = 0.1 g and nu = 0.001 g^2 of the clipped gradient,
  and the two packages' bfloat16 backward passes round at different
  points, so their gradients agree to about 3% of each leaf's norm, and
  their squares to about 6%;
* the step each parameter takes, p_after - p_before, to one bfloat16 ulp
  of the parameter plus lr / 20, elementwise. At lr = 1e-2 the first
  Adam step is lr * g / (|g| + eps), about lr = 10 ulps of a weight of
  0.1, plus the decay lr * wd * p, which wd = 1 makes one to three ulps
  of p, so a step of the wrong sign, size, bias correction, decay or
  decay mask lies outside. Two packages that compute the same update may
  round it to neighbouring bfloat16 values: the ulp. The lr / 20 is the
  spread of g / (|g| + eps) between bfloat16 gradients that agree in
  sign and exceed 100 eps. Where they do not (about 1% of the elements:
  gradients near zero, whose signs the two backward passes may round
  differently, or of the size of eps), the two steps may differ by up
  to 2 lr; those elements are left to the moments' check, and at least
  95% of every leaf must be held elementwise.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.convert import (
    flax_opt_state_to_torch,
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from progen_tpu_torch.training import optimizer as toptimizer
from progen_tpu_torch.training.step import init_train_state, make_train_step
from torch_sgu_split import bf16_ulp

CFG = dict(num_tokens=32, dim=64, seq_len=32, depth=3, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="bfloat16", param_dtype="bfloat16")
LR, WD, CLIP = 1e-2, 1.0, 0.5


@pytest.fixture(scope="module")
def tree():
    """The JAX init in bfloat16, as numpy, with the SGU weights and biases
    and the norm scales redrawn."""
    cfg = jcfg.ProGenConfig(**CFG)
    params = flax.linen.meta.unbox(jax.jit(JProGen(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.seq_len), jnp.int32)
    )["params"])
    rng = np.random.default_rng(0)

    def redraw(path, leaf):
        name, a = path[-1].key, np.asarray(leaf)
        if name == "spatial_weights":
            return (rng.standard_normal(a.shape)
                    / np.sqrt(cfg.seq_len)).astype(a.dtype)
        if name == "spatial_biases":
            return rng.standard_normal(a.shape).astype(a.dtype)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


def _port(tree) -> ProGen:
    model = ProGen(ProGenConfig(**CFG), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(tree,
                                                    ProGenConfig(**CFG)))
    return model


def _batch(seed: int = 1) -> np.ndarray:
    """(grad_accum 2, micro_batch 2, seq_len + 1) tokens, one sequence of
    each micro-batch ending in padding."""
    toks = np.random.default_rng(seed).integers(1, 32, (2, 2, 33))
    toks[:, 1, 20:] = 0
    return toks.astype(np.int32)


def test_parameters_take_param_dtype(tree):
    model = ProGen(ProGenConfig(**CFG), device="cpu")
    want = flax_params_to_state_dict(tree, ProGenConfig(**CFG))
    assert {n: p.dtype for n, p in model.state_dict().items()} == \
        {n: t.dtype for n, t in want.items()}
    assert all(t.dtype == torch.bfloat16 for t in want.values())
    model.load_state_dict(want)
    for name, p in model.state_dict().items():
        assert torch.equal(p, want[name]), name
    back = state_dict_to_flax_params(model.state_dict(),
                                     ProGenConfig(**CFG))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.int16), np.asarray(b).view(np.int16))
    f32 = ProGen(ProGenConfig(**{**CFG, "param_dtype": "float32"}),
                 device="cpu")
    assert all(p.dtype == torch.float32 for p in f32.parameters())


def test_logits_match_jax(tree):
    toks = _batch()[0, :, :-1]
    jm = JProGen(jcfg.ProGenConfig(**CFG))
    want = np.asarray(jax.jit(jm.apply)({"params": tree}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port(tree)(torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.1, rtol=0)


def test_train_step_matches_jax(tree):
    batch = _batch()
    model = JProGen(jcfg.ProGenConfig(**CFG))
    opt = joptimizer.make_optimizer(LR, WD, CLIP)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, tree), opt)
    jstate, jm = jax.jit(jstep.make_train_step(model, opt))(
        jstate, jnp.asarray(batch))

    cfg = ProGenConfig(**CFG)
    state = init_train_state(cfg, toptimizer.OptimizerConfig(LR, WD, CLIP),
                             device="cpu")
    state.model.load_state_dict(flax_params_to_state_dict(tree, cfg))
    state, m = make_train_step()(state, torch.from_numpy(batch))

    assert int(m["skipped"]) == 0 and int(jm["skipped"]) == 0
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-2)
    jopt = flax_opt_state_to_torch(
        jax.tree.map(np.asarray, jstate.opt_state), cfg)
    assert jopt["count"] == state.optimizer.count == 1
    for key, rtol in (("mu", 0.05), ("nu", 0.1)):
        for name, got in getattr(state.optimizer, key).items():
            ref = jopt[key][name]
            assert got.dtype == ref.dtype == torch.bfloat16, (key, name)
            gap = (got.float() - ref.float()).norm() / ref.float().norm()
            assert gap < rtol, (key, name, float(gap))

    start = flax_params_to_state_dict(tree, cfg)
    want = flax_params_to_state_dict(
        jax.tree.map(np.asarray, jstate.params), cfg)
    for name, p in state.model.state_dict().items():
        assert p.dtype == want[name].dtype == torch.bfloat16, name
        p0 = start[name].float()
        got, ref = p.float() - p0, want[name].float() - p0
        mu, mu_ref = state.optimizer.mu[name].float(), \
            jopt["mu"][name].float()
        # gradients of one sign in both packages, each over 100 eps
        # (mu = 0.1 g), or zero in both
        same_sign = torch.sign(mu) == torch.sign(mu_ref)
        large = torch.minimum(mu.abs(), mu_ref.abs()) > 1e-7
        held = same_sign & large | (mu == 0) & (mu_ref == 0)
        assert float(held.float().mean()) >= 0.95, name
        tol = bf16_ulp(torch.maximum(p.float().abs(),
                                     want[name].float().abs()))
        off = ((got - ref).abs() > tol + LR / 20) & held
        assert not bool(off.any()), (name, got[off][:4], ref[off][:4])
        assert torch.equal(torch.sign(got[held]), torch.sign(ref[held])), \
            name
