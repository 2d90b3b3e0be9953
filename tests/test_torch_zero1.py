"""The port's ZeRO-1 and its checkpoints on a grid, against the JAX
package, with gloo ranks spawned on the CPU.

At the tiny float32 config of ``tests/test_torch_tensor_parallel.py``
(heads 4), a (data 2, seq 1, model 2) grid takes 3 steps of
``make_train_step(grid)`` without and then with ZeRO-1 from the same
weights (``tests/torch_grid_worker.py``), and its coordinator saves the
ZeRO-1 state. The tests hold:

* the ZeRO-1 parameters bit-equal to the same grid's without it, and
  each rank's moment bytes half of the whole on the tensors that can be
  cut (whole on the others);
* the trajectory against the JAX package's ZeRO-1 trajectory on a (2, 1,
  2) mesh: the loss at ``tests/test_train.py:329-402``'s tolerance (1e-6
  relative); the parameters at 1e-5 absolute, the port's tolerance for 3
  steps against the JAX package (``tests/test_torch_train.py`` gives the
  reason: an element whose gradient is float32 noise sits in Adam's eps
  regime, where the two packages' roundings move it apart). That JAX
  test's 1e-6 holds JAX against itself; here one weight of 6144 was
  1.5e-6 apart after 3 steps at its learning rate of 1e-3, and every
  other agreed within 1e-6;
* the checkpoint: restored bit for bit (parameters, moments, count,
  step) in one process and in a (model 2) grid, and training resumed
  from it in that grid against one process resumed from it (the step's
  tolerance, 1e-5 relative and 2e-5 absolute); a checkpoint of the JAX
  package, imported, resumed into a (model 2) grid against the JAX
  single-device step from it;
* ``shard_state_dict`` then ``gather_state_dict``: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.checkpoint import Package as JPackage
from progen_tpu.checkpoint import get_checkpoint_fns as jax_checkpoint_fns
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.parallel.partition import make_mesh
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.convert import (
    flax_params_to_state_dict,
    gather_state_dict,
    shard_state_dict,
)
from progen_tpu_torch.parallel.partition import zero1_dim
from progen_tpu_torch.parallel.tensor import layout
from progen_tpu_torch.training.optimizer import OptimizerConfig
from progen_tpu_torch.training.step import init_train_state, make_train_step
from test_torch_tensor_parallel import CFG, redrawn
from torch_grid_worker import spawn
from torch_jax_ckpt import import_jax_checkpoint

RANK_TIMEOUT = 120
STEPS = 3
LR = 1e-3  # the JAX ZeRO-1 test's


@pytest.fixture(scope="module")
def tree():
    return redrawn(jcfg.ProGenConfig(**CFG), seed=2)


@pytest.fixture(scope="module")
def batches():
    """Three (1, 8, 65) batches, and a fourth for the resumed step."""
    rng = np.random.default_rng(5)
    b = rng.integers(1, 32, (STEPS + 1, 1, 8, 65)).astype(np.int32)
    b[0, 0, 2, 40:] = 0
    b[1, 0, 5, 11:] = 0
    return b


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("zero1")


@pytest.fixture(scope="module")
def jax_ckpt(tree, batches, root):
    """A checkpoint of the JAX package after one step, imported into the
    port's format; and the JAX single-device step from it: (directory,
    params as a state dict, metrics)."""
    cfg = jcfg.ProGenConfig(**CFG)
    opt = joptimizer.make_optimizer(LR, 1e-3, 0.5)
    state = JTrainState.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jstep.make_train_step(JProGen(cfg), opt))
    state, _ = step(state, jnp.asarray(batches[0]))
    _, _, jsave = jax_checkpoint_fns(str(root / "jck"))
    jsave(JPackage(next_seq_index=8, state=state, model_config=dict(CFG),
                   run_id="jax", train_config=None))
    import_jax_checkpoint(str(root / "jck"), str(root / "tck"))
    state, metrics = step(state, jnp.asarray(batches[STEPS]))
    return (str(root / "tck"),
            flax_params_to_state_dict(jax.tree.map(np.asarray, state.params),
                                      ProGenConfig(**CFG)),
            {k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module")
def run(tree, batches, root, jax_ckpt):
    """The (2, 1, 2) grid's ranks, then the (1, 1, 2) grid resuming the
    checkpoint its coordinator wrote and the imported JAX checkpoint."""
    torch.save({"config": CFG,
                "state_dict": flax_params_to_state_dict(
                    tree, ProGenConfig(**CFG)),
                "batches": [torch.from_numpy(b).long()
                            for b in batches[:STEPS]],
                "batch": torch.from_numpy(batches[STEPS]).long()},
               root / "inputs.pt")
    ckpt = str(root / "ck")
    ranks = spawn(4, "zero1", root, RANK_TIMEOUT, 2, 2, STEPS, ckpt)
    resumed = spawn(2, "resume", root, RANK_TIMEOUT, 1, 2,
                    (ckpt, jax_ckpt[0]))
    return dict(root=root, ckpt=ckpt, ranks=ranks,
                resumed=[r[ckpt] | {"coords": r["coords"]} for r in resumed],
                jax_resumed=[r[jax_ckpt[0]] for r in resumed])


def test_zero1_leaves_the_parameters_bit_equal(run):
    for r in run["ranks"]:
        assert r[True]["metrics"] == r[False]["metrics"]
        for name, p in r[False]["params"].items():
            assert torch.equal(r[True]["params"][name], p), name


def test_zero1_halves_each_ranks_moment_bytes(run):
    cut_any = 0
    for r in run["ranks"]:
        whole, sliced = r[False]["moment_bytes"], r[True]["moment_bytes"]
        for name, nbytes in whole.items():
            if r[True]["cut"][name] is None:
                assert sliced[name] == nbytes, name
            else:
                assert 2 * sliced[name] == nbytes, name
                cut_any += 1
        # every tensor the rule can cut was cut, never on its
        # tensor-parallel dim
        for name in whole:
            spec = layout(name, ProGenConfig(**CFG))
            tp_dim = None if spec is None else spec[0]
            shape = r[False]["params"][name].shape
            assert r[True]["cut"][name] == zero1_dim(shape, tp_dim, 2)
            assert tp_dim is None or r[True]["cut"][name] != tp_dim
    assert cut_any > 0
    total = sum(run["ranks"][0][False]["moment_bytes"].values())
    assert sum(run["ranks"][0][True]["moment_bytes"].values()) < 0.6 * total


@pytest.fixture(scope="module")
def jax_zero1(tree, batches):
    """The JAX package's ZeRO-1 trajectory on a (2, 1, 2) mesh from the
    same weights: (params as a state dict, last metrics)."""
    cfg = jcfg.ProGenConfig(**CFG)
    model = JProGen(cfg)
    opt = joptimizer.make_optimizer(LR, 1e-3, 0.5)
    mesh = make_mesh(data=2, seq=1, model=2)
    boxed, _ = jstep.abstract_train_state(model, opt, cfg.seq_len)
    shardings = jstep.train_state_shardings(boxed, mesh, zero1=True)
    state = jax.device_put(
        JTrainState.create(jax.tree.map(jnp.asarray, tree), opt), shardings)
    step = jstep.compile_train_step(model, opt, state, shardings, mesh)
    with mesh:
        for b in batches[:STEPS]:
            state, metrics = step(state, jnp.asarray(b))
    return (flax_params_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(state.params)),
        ProGenConfig(**CFG)), {k: float(v) for k, v in metrics.items()})


def test_zero1_trajectory_matches_jax_zero1(run, jax_zero1):
    want_params, want_metrics = jax_zero1
    for r in run["ranks"]:
        got = r[True]["metrics"][-1]
        np.testing.assert_allclose(got["loss"], want_metrics["loss"],
                                   rtol=1e-6)
    whole = run["ranks"][0]["whole"]["params"]
    for name, want in want_params.items():
        np.testing.assert_allclose(whole[name].numpy(), want.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def _single_state(config_dict):
    return init_train_state(ProGenConfig(**config_dict),
                            OptimizerConfig(LR, 1e-3, 0.5), seed=None,
                            device="cpu")


def test_checkpoint_restores_bit_equal_in_one_process(run):
    want = run["ranks"][0]["whole"]
    _, get_last, _ = get_checkpoint_fns(run["ckpt"])
    state = _single_state(CFG)
    pkg = get_last(state)
    assert pkg.next_seq_index == 8 and pkg.run_id == "grid"
    assert state.step == want["step"] == STEPS
    assert state.optimizer.count == want["count"] == STEPS
    for name, p in state.model.state_dict().items():
        assert torch.equal(p, want["params"][name]), name
    for key in ("mu", "nu"):
        for name, t in getattr(state.optimizer, key).items():
            assert torch.equal(t, want[key][name]), (key, name)


def test_checkpoint_restores_bit_equal_in_a_model_grid(run):
    want = run["ranks"][0]["whole"]
    cfg = ProGenConfig(**CFG)
    for r in run["resumed"]:
        grid = type("G", (), {"model": 2, "model_index": r["coords"][2]})
        assert r["step"] == STEPS and r["count"] == STEPS
        assert r["next_seq_index"] == 8
        for key, got in (("params", r["params"]), ("mu", r["mu"]),
                         ("nu", r["nu"])):
            mine = shard_state_dict(want[key], cfg, grid)
            for name, t in got.items():
                assert torch.equal(t, mine[name]), (key, name)


def test_training_resumes_in_a_grid_as_in_one_process(run, batches):
    _, get_last, _ = get_checkpoint_fns(run["ckpt"])
    state = _single_state(CFG)
    get_last(state)
    _, m = make_train_step()(state, torch.from_numpy(batches[STEPS]).long())
    for r in run["resumed"]:
        for key in ("loss", "grad_norm"):
            assert r["metrics"][key] == pytest.approx(m[key].item(),
                                                      rel=1e-5), key
        for name, p in state.model.state_dict().items():
            np.testing.assert_allclose(r["after"][name].numpy(), p.numpy(),
                                       atol=2e-5, rtol=0, err_msg=name)


def test_a_jax_checkpoint_resumes_into_a_grid(run, jax_ckpt):
    """A checkpoint of the JAX package (one step taken), imported, then
    one step in a (model 2) grid against the JAX step from it."""
    _, want, metrics = jax_ckpt
    for r in run["jax_resumed"]:
        assert r["step"] == 1 and r["next_seq_index"] == 8
        for key in ("loss", "grad_norm"):
            assert r["metrics"][key] == pytest.approx(metrics[key],
                                                      rel=1e-5), key
        for name, p in want.items():
            np.testing.assert_allclose(r["after"][name].numpy(), p.numpy(),
                                       atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_bit_equal(run, model):
    """A whole train payload (parameters and moments) cut into every
    model rank's shards and put back together."""
    want = run["ranks"][0]["whole"]
    cfg = ProGenConfig(**CFG)
    payload = {"params": want["params"], "step": 3,
               "optimizer": {"count": 3, "mu": want["mu"],
                             "nu": want["nu"]}}
    shards = [shard_state_dict(
        payload, cfg, type("G", (), {"model": model, "model_index": i}))
        for i in range(model)]
    for s in shards:  # each a real cut, not the whole
        assert s["params"]["embed"].shape[0] == cfg.num_tokens // model
    back = gather_state_dict(shards, cfg)
    assert back["step"] == 3 and back["optimizer"]["count"] == 3
    for key, got in (("params", back["params"]),
                     ("mu", back["optimizer"]["mu"]),
                     ("nu", back["optimizer"]["nu"])):
        for name, t in want[key].items():
            assert torch.equal(got[name], t), (key, name)
