"""The port's tensor parallelism against the JAX package, with gloo ranks
spawned on the CPU.

Grids (data 1, seq 1, model 2), (data 2, seq 1, model 2) and (data 1,
seq 2, model 2) at a tiny float32 config (dim 32, depth 3 with one gMLP
layer, heads 4 so that model 2 splits them, window 8, seq_len 64). Each
grid's ranks run once (``tests/torch_grid_worker.py``), inside
``init_process_group``'s timeout and a bounded join that fails the test:
the sharded forward, the gradients of the summed logits (remat off and
on) summed over the grid and gathered whole, and one
``make_train_step(grid)`` step. The tests hold them against:

* the JAX ``ProGen`` on ``make_mesh(data=1, seq=1, model=2)`` under
  ``logical_rules``: logits to 2e-5 absolute and gradients to 3e-3
  absolute plus 2e-5 relative, as ``tests/test_torch_parallel.py`` holds
  its grids (from ``tests/test_ring_attention.py``'s parity);
* the JAX single-device train step: loss and grad norm to 1e-5
  relative, the parameters to 2e-5 absolute
  (``tests/test_train.py:214``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.parallel.partition import (
    logical_rules,
    make_mesh,
    param_shardings,
)
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.convert import flax_params_to_state_dict
from progen_tpu_torch.parallel.tensor import (
    check_divisible,
    layout,
    shard,
    unshard,
)
from torch_grid_worker import spawn

CFG = dict(num_tokens=32, dim=32, seq_len=64, depth=3, window_size=8,
           global_mlp_depth=1, heads=4, dim_head=16, ff_mult=2,
           dtype="float32")
GRIDS = [(1, 1, 2), (2, 1, 2), (1, 2, 2)]
RANK_TIMEOUT = 120  # seconds, for the collectives and the join alike


def redrawn(cfg, seed: int = 0):
    """The JAX model's init with the SGU weights and biases and the norm
    scales redrawn from numpy, so every parameter matters at this size."""
    params = flax.linen.meta.unbox(jax.jit(JProGen(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.seq_len), jnp.int32)
    )["params"])
    rng = np.random.default_rng(seed)

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


@pytest.fixture(scope="module")
def tree():
    return redrawn(jcfg.ProGenConfig(**CFG))


@pytest.fixture(scope="module")
def data():
    """Tokens (4, 64) for the forward; a (2, 4, 65) train batch whose
    rows end in padding at several places, one first pad at the seq
    shard boundary (position 32 of the labels)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 32, (4, 64)).astype(np.int32)
    batch = rng.integers(1, 32, (2, 4, 65)).astype(np.int32)
    batch[0, 1, 33:] = 0
    batch[1, 2, 20:] = 0
    batch[:, 3, 57:] = 0
    return tokens, batch


@pytest.fixture(scope="module")
def ranks(tree, data, tmp_path_factory):
    """Each grid's ranks, run once: {grid: [result of rank r]}."""
    tokens, batch = data
    out = {}
    for grid in GRIDS:
        d = tmp_path_factory.mktemp("grid" + "x".join(map(str, grid)))
        torch.save({"config": CFG, "tokens": torch.from_numpy(tokens).long(),
                    "batch": torch.from_numpy(batch).long(),
                    "state_dict": flax_params_to_state_dict(
                        tree, ProGenConfig(**CFG))}, d / "inputs.pt")
        out[grid] = spawn(int(np.prod(grid)), "tensor_parallel", d,
                          RANK_TIMEOUT, *grid)
    return out


@pytest.fixture(scope="module")
def jax_tp(tree, data):
    """The JAX model with its parameters laid out on a (1, 1, 2) mesh by
    the rule table: its logits and the gradients of their sum."""
    cfg = jcfg.ProGenConfig(**CFG)
    model = JProGen(cfg)
    mesh = make_mesh(data=1, seq=1, model=2)
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, cfg.seq_len), jnp.int32))["params"]
    params = jax.device_put(jax.tree.map(jnp.asarray, tree),
                            param_shardings(boxed, mesh))
    tokens = jnp.asarray(data[0])

    def loss(p):
        logits = model.apply({"params": p}, tokens)
        return logits.astype(jnp.float32).sum(), logits

    with mesh, logical_rules():
        grads, logits = jax.jit(jax.grad(loss, has_aux=True))(params)
    return np.asarray(logits), flax_params_to_state_dict(
        jax.tree.map(np.asarray, grads), ProGenConfig(**CFG))


@pytest.fixture(scope="module")
def jax_step(tree, data):
    """One JAX single-device train step from the same weights: (params as
    a state dict, metrics)."""
    cfg = jcfg.ProGenConfig(**CFG)
    opt = joptimizer.make_optimizer(2e-4, 1e-3, 0.5)
    state = JTrainState.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jstep.make_train_step(JProGen(cfg), opt))
    state, metrics = step(state, jnp.asarray(data[1]))
    return (flax_params_to_state_dict(jax.tree.map(np.asarray,
                                                   state.params),
                                      ProGenConfig(**CFG)),
            {k: float(v) for k, v in metrics.items()})


def _ids(grid):
    return "data{}_seq{}_model{}".format(*grid)


def _whole_logits(results, grid):
    """The ranks' logit blocks (rows, positions, vocab columns) put back
    into (batch, n, vocab)."""
    data, seq, model = grid
    blocks = {r["coords"]: r["logits"] for r in results}
    return torch.cat([torch.cat([torch.cat([blocks[d, s, m]
                                            for m in range(model)], -1)
                                 for s in range(seq)], 1)
                      for d in range(data)], 0)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_ranks_hold_their_coordinates(ranks, grid):
    data, seq, model = grid
    got = [r["coords"] for r in ranks[grid]]
    assert got == [(d, s, m) for d in range(data) for s in range(seq)
                   for m in range(model)]


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_sharded_logits_match_jax_tp_model(ranks, jax_tp, grid):
    got = _whole_logits(ranks[grid], grid)
    np.testing.assert_allclose(got.numpy(), jax_tp[0], atol=2e-5)


@pytest.mark.parametrize("remat", [False, True],
                         ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_gradients_match_jax_tp_model(ranks, jax_tp, grid, remat):
    want = jax_tp[1]
    for r in ranks[grid]:
        got = r[f"grads_remat_{remat}"]
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name].numpy(),
                                       want[name].numpy(), atol=3e-3,
                                       rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_train_step_matches_jax_single_device(ranks, jax_step, grid):
    want_params, want_metrics = jax_step
    for r in ranks[grid]:
        m = r["metrics"]
        assert m["skipped"] == 0
        for key in ("loss", "last_micro_loss", "grad_norm"):
            assert m[key] == pytest.approx(want_metrics[key], rel=1e-5), key
        for name, want in want_params.items():
            np.testing.assert_allclose(r["params"][name].numpy(),
                                       want.numpy(), atol=2e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_a_copied_state_steps_on_the_same_grid(ranks, grid):
    """``copy.deepcopy`` of a train state on a grid (as a caller takes to
    try one step twice) shares the grid and steps bit-equal."""
    for r in ranks[grid]:
        assert r["twin_on_grid"]
        for name, p in r["params"].items():
            assert torch.equal(r["twin_params"][name], p), name


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_every_rank_takes_the_same_step(ranks, grid):
    """One reduction, one decision, one update: the gathered parameters
    and the metrics agree on every rank, bit for bit."""
    first = ranks[grid][0]
    for r in ranks[grid][1:]:
        assert r["metrics"] == first["metrics"]
        for name, p in first["params"].items():
            assert torch.equal(r["params"][name], p), name


def test_a_qkv_shard_holds_q_k_and_v_of_its_heads():
    cfg = ProGenConfig(**CFG)
    inner = cfg.inner_dim
    # row i of the fused weight is labelled by its (part, head) pair
    part = torch.arange(3 * inner) // inner
    head = (torch.arange(3 * inner) % inner) // cfg.dim_head
    w = (part * 100 + head).float()[:, None].expand(-1, cfg.dim)
    spec = layout("attn.0.to_qkv.weight", cfg)
    for index in range(2):
        got = shard(w, spec, 2, index)[:, 0].long()
        heads = range(index * 2, index * 2 + 2)
        want = [p * 100 + h for p in range(3) for h in heads
                for _ in range(cfg.dim_head)]
        assert got.tolist() == want


def test_a_glu_shard_holds_its_columns_of_both_halves():
    cfg = ProGenConfig(**CFG)
    hidden = cfg.dim * cfg.ff_mult  # each half's width
    w = torch.arange(2 * hidden).float()[:, None]
    spec = layout("ff.0.proj_in.weight", cfg)
    assert spec == (0, 2)
    got = shard(w, spec, 2, 1)[:, 0].long().tolist()
    assert got == list(range(hidden // 2, hidden)) + \
        list(range(hidden + hidden // 2, 2 * hidden))
    assert torch.equal(unshard([shard(w, spec, 2, i) for i in range(2)],
                               spec), w)
    # the gMLP layer's proj_in is gathered whole: one contiguous part
    assert layout("ff.2.proj_in.weight", cfg) == (0, 1)


def test_widths_that_do_not_divide_are_refused():
    with pytest.raises(ValueError, match="heads"):
        check_divisible(ProGenConfig(**{**CFG, "heads": 3}), 2)
