"""The port's GPipe and 1F1B pipelines against the JAX package, with gloo
ranks spawned on the CPU.

The config of ``tests/test_pipeline.py``'s train-step parity (dim 32,
depth 5 with one gMLP layer, so 4 uniform layers, window 8, seq_len 32,
scan_layers) with heads 4. Two stages with M = 2 and 4 microbatches, and
data 2 x 2 stages with M = 2 (``tests/torch_grid_worker.py``, each grid
inside a collective timeout and a bounded join). For each schedule the
tests hold:

* one micro-step's loss and gradients (summed over data) against the
  JAX package's plain loss and its gradients on the same rows: the loss
  to 1e-5 relative (``tests/test_pipeline_1f1b.py``'s loss parity), the
  gradients at each schedule's JAX test tolerance, GPipe 5e-3 absolute
  plus 2e-5 relative (``tests/test_pipeline.py``'s gradient parity),
  1F1B 1e-5 absolute plus 1e-4 relative;
* one step of ``make_pipeline_train_step`` / ``make_1f1b_train_step``
  against the JAX twin (with M = 2) on a (data, 1, 2) mesh from the same
  weights, at
  the JAX tests' learning rate (1e-3): the loss, the last micro-step's
  loss and the grad norm to 1e-6 relative (their loss tolerance), and
  the parameters to 5e-5 absolute (``tests/test_pipeline_1f1b.py``'s).
  ``tests/test_pipeline.py`` holds GPipe to 2e-5, JAX against itself;
  across the two packages one weight of 2048 came 2.3e-5 apart (an
  element in Adam's eps regime, as ``tests/test_torch_train.py``
  explains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.parallel.partition import make_mesh
from progen_tpu.parallel.pipeline import make_pipeline_train_step as jgpipe
from progen_tpu.parallel.pipeline_1f1b import make_1f1b_train_step as j1f1b
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGenConfig
from progen_tpu_torch.convert import flax_params_to_state_dict
from progen_tpu_torch.parallel.pipeline import stage_of
from test_torch_tensor_parallel import redrawn
from torch_grid_worker import spawn

CFG = dict(num_tokens=32, dim=32, seq_len=32, depth=5, window_size=8,
           global_mlp_depth=1, heads=4, dim_head=16, ff_mult=2,
           dtype="float32", scan_layers=True)
RUNS = {(1, 2): (2, 4), (2, 2): (2,)}  # (data, stages): microbatches
SCHEDULES = ("gpipe", "1f1b")
CASES = [(d, p, s, m) for (d, p), ms in RUNS.items() for s in SCHEDULES
         for m in ms]
GRAD_TOL = {"gpipe": dict(atol=5e-3, rtol=2e-5),
            "1f1b": dict(atol=1e-5, rtol=1e-4)}
PARAM_ATOL = 5e-5
RANK_TIMEOUT = 120


def _ids(case):
    return "data{}_stages{}_{}_m{}".format(*case)


@pytest.fixture(scope="module")
def tree():
    return redrawn(jcfg.ProGenConfig(**CFG), seed=3)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    b = rng.integers(1, 32, (2, 8, 33)).astype(np.int32)
    b[0, 1, 20:] = 0
    b[1, 6, 9:] = 0
    return b


@pytest.fixture(scope="module")
def ranks(tree, batch, tmp_path_factory):
    out = {}
    for (data, stages), ms in RUNS.items():
        d = tmp_path_factory.mktemp(f"pipe{data}x{stages}")
        torch.save({"config": CFG, "batch": torch.from_numpy(batch).long(),
                    "state_dict": flax_params_to_state_dict(
                        tree, ProGenConfig(**CFG))}, d / "inputs.pt")
        out[data, stages] = spawn(data * stages, "pipeline", d, RANK_TIMEOUT,
                                  data, stages, SCHEDULES, ms)
    return out


@pytest.fixture(scope="module")
def jax_plain(tree, batch):
    """The JAX plain loss of the first micro-step's rows and its
    gradients, as a state dict."""
    model = JProGen(jcfg.ProGenConfig(**CFG))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.batch_loss(model, p, jnp.asarray(batch[0]))))(
        jax.tree.map(jnp.asarray, tree))
    return float(loss), flax_params_to_state_dict(
        jax.tree.map(np.asarray, grads), ProGenConfig(**CFG))


@pytest.fixture(scope="module")
def jax_steps(tree, batch):
    """One step of each JAX pipeline train step from the same weights,
    with M = 2 (the schedule's step is the same function for any M; the
    JAX tests hold it to the plain step):
    {(data, stages, schedule): (params as a state dict, metrics)}."""
    model = JProGen(jcfg.ProGenConfig(**CFG))
    opt = joptimizer.make_optimizer(1e-3, 1e-3, 0.5)
    out = {}
    for data, stages, schedule in {c[:3] for c in CASES}:
        mesh = make_mesh(data=data, seq=1, model=stages)
        make = jgpipe if schedule == "gpipe" else j1f1b
        step = jax.jit(make(model, opt, mesh=mesh, n_microbatches=2))
        state = JTrainState.create(jax.tree.map(jnp.asarray, tree), opt)
        with mesh:
            state, metrics = step(state, jnp.asarray(batch))
        out[data, stages, schedule] = (
            flax_params_to_state_dict(jax.tree.map(np.asarray, state.params),
                                      ProGenConfig(**CFG)),
            {k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_micro_step_matches_jax_loss_and_gradients(ranks, jax_plain, case):
    data, stages, schedule, m = case
    want_loss, want_grads = jax_plain
    for r in ranks[data, stages]:
        got = r[schedule, m]
        assert got["loss"] == pytest.approx(want_loss, rel=1e-5)
        assert got["grads"].keys() == want_grads.keys()
        for name, want in want_grads.items():
            np.testing.assert_allclose(got["grads"][name].numpy(),
                                       want.numpy(), err_msg=name,
                                       **GRAD_TOL[schedule])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_train_step_matches_jax_twin(ranks, jax_steps, case):
    data, stages, schedule, m = case
    want_params, want_metrics = jax_steps[case[:3]]
    for r in ranks[data, stages]:
        got = r[schedule, m]
        assert got["metrics"].get("skipped", 0) == 0
        assert ("skipped" in got["metrics"]) == (schedule == "gpipe")
        for key in ("loss", "last_micro_loss", "grad_norm"):
            assert got["metrics"][key] == pytest.approx(
                want_metrics[key], rel=1e-6), key
        for name, want in want_params.items():
            np.testing.assert_allclose(got["params"][name].numpy(),
                                       want.numpy(), rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("grid", list(RUNS), ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_rank_takes_the_same_step(ranks, grid):
    first = ranks[grid][0]
    for r in ranks[grid][1:]:
        for key, res in first.items():
            if key == "coords":
                continue
            assert r[key]["metrics"] == res["metrics"]
            for name, p in res["params"].items():
                assert torch.equal(r[key]["params"][name], p), name


def test_each_parameter_lives_on_one_stage():
    cfg = ProGenConfig(**CFG)
    assert stage_of("embed", cfg, 2) == 0
    assert stage_of("attn.1.to_qkv.weight", cfg, 2) == 0
    assert stage_of("ff.2.proj_in.bias", cfg, 2) == 1
    assert stage_of("attn.4.norm.scale", cfg, 2) == 1  # the gMLP layer
    assert stage_of("to_logits.weight", cfg, 2) == 1
    with pytest.raises(ValueError, match="not divisible by 3"):
        stage_of("attn.0.to_out.bias", cfg, 3)
