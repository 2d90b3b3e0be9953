"""The port's data- and sequence-parallel training against the JAX
package, with gloo ranks spawned on the CPU.

Grids (data 2, seq 2) and (data 1, seq 4) at the tiny float32 config of
``tests/test_ring_attention.py``'s model tests (dim 32, depth 3 with one
gMLP layer, window 8, seq_len 64; a shard of 16 or 32 positions). Each
grid's ranks run once (``tests/torch_parallel_worker.py``), inside
``init_process_group``'s timeout and a bounded join that fails the test.
They run the sharded forward, the gradients of the summed logits (remat
off and on) summed over the grid, and one ``make_train_step(grid)``
step; the tests hold them against:

* the JAX ``ProGen`` with ``use_ring_attn`` on ``make_mesh(data=2,
  seq=2)``: logits to 2e-5 absolute and gradients to 3e-3 absolute plus
  2e-5 relative, as that file's forward and gradient parity do (float32
  sums in another order, over a loss of 8192 logits), the port's remat
  off and on alike;
* the JAX single-device train step: loss and grad norm to 1e-5 relative
  and the parameters to 2e-5 absolute, as ``tests/test_train.py`` holds
  its sharded step against the single-device one.

Weights: the JAX model's init with the SGU weights and biases and the
norm scales redrawn from numpy, so every parameter matters at this size.
"""

import shutil

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.parallel.partition import make_mesh
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.convert import flax_params_to_state_dict
from torch_parallel_worker import spawn_ranks

CFG = dict(num_tokens=32, dim=32, seq_len=64, depth=3, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="float32")
GRIDS = [(2, 2), (1, 4)]
RANK_TIMEOUT = 120  # seconds, for the collectives and the join alike


@pytest.fixture(scope="module")
def tree():
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


@pytest.fixture(scope="module")
def data():
    """Tokens (4, 64) for the forward; a (2, 4, 65) train batch whose
    rows end in padding at several places, one first pad exactly at a
    shard boundary of both grids (position 32 of the labels) and one in
    the last shard."""
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
    workdir = tmp_path_factory.mktemp("ranks")
    torch.save({"config": CFG, "tokens": torch.from_numpy(tokens).long(),
                "batch": torch.from_numpy(batch).long(),
                "state_dict": flax_params_to_state_dict(
                    tree, ProGenConfig(**CFG))},
               workdir / "inputs.pt")
    out = {}
    for data_size, seq in GRIDS:
        d = workdir / f"grid{data_size}x{seq}"
        d.mkdir()
        shutil.copy(workdir / "inputs.pt", d / "inputs.pt")
        out[data_size, seq] = spawn_ranks(data_size, seq, d, RANK_TIMEOUT)
    return out


@pytest.fixture(scope="module")
def jax_ring(tree, data):
    """The JAX ring model on a (data 2, seq 2) mesh: its logits and the
    gradients of their sum, in one compiled call. Its remat is off: the
    JAX package holds the ring model's remat gradients to the same
    function (``tests/test_ring_attention.py``), so the port's remat on
    and off are both held against these."""
    cfg = jcfg.ProGenConfig(use_ring_attn=True, **CFG)
    model = JProGen(cfg, mesh=make_mesh(data=2, seq=2, model=1))
    tokens = jnp.asarray(data[0])

    def loss(p):
        logits = model.apply({"params": p}, tokens)
        return logits.astype(jnp.float32).sum(), logits

    grads, logits = jax.jit(jax.grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
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
    return f"data{grid[0]}_seq{grid[1]}"


def _whole_logits(results, data_size, seq):
    """The ranks' logit shards put back into (batch, n, vocab)."""
    rows = [torch.cat([r["logits"] for r in results
                       if r["data_index"] == d], dim=1)
            for d in range(data_size)]
    return torch.cat(rows, dim=0)


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_ranks_hold_their_coordinates(ranks, grid):
    data_size, seq = grid
    got = [(r["data_index"], r["seq_index"]) for r in ranks[grid]]
    assert got == [divmod(rank, seq) for rank in range(data_size * seq)]


@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_sharded_logits_match_jax_ring_model(ranks, jax_ring, grid):
    got = _whole_logits(ranks[grid], *grid)
    np.testing.assert_allclose(got.numpy(), jax_ring[0], atol=2e-5)


@pytest.mark.parametrize("remat", [False, True],
                         ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("grid", GRIDS, ids=_ids)
def test_gradients_match_jax_ring_model(ranks, jax_ring, grid, remat):
    want = jax_ring[1]
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
def test_every_rank_takes_the_same_step(ranks, grid):
    """The replicas stay equal: one reduction, one decision, one
    update on every rank."""
    first = ranks[grid][0]
    for r in ranks[grid][1:]:
        assert r["metrics"] == first["metrics"]
        for name, p in first["params"].items():
            assert torch.equal(r["params"][name], p), name
