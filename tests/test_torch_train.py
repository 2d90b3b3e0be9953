"""The port's training path against the JAX package, at a small size on
the CPU.

Config: dim 64, depth 3 (2 uniform layers + 1 gMLP layer), heads 2,
dim_head 16, window 8, seq_len 32, ff_mult 2, vocab 32, float32 compute.
Weights come from the JAX model's init with the SGU weights and biases
and the norm scales redrawn from numpy (so every parameter matters at
this size) and go to the port through ``convert.py``; batches are numpy
tokens with padded tails, so the EOS mask is exercised.

Tolerances, each with its reason:
* the loss and the grad norm to 1e-5 relative: float32 sums over the
  same terms in another order;
* params after each of 3 steps to 1e-5 absolute, wider than the 5e-6
  ``tests/test_reference_parity.py`` holds the JAX step to: one element
  of ``attn.1.to_qkv.weight`` has a first-step gradient of about 1e-9
  (float32 noise against gradients near 1e-2), which the two packages
  take as 1.5e-9 and 1.2e-9; in Adam's eps regime, u = g / (|g| + 1e-8),
  that 3e-10 turns into 0.026 of an update, 5.1e-6 at lr 2e-4. Every
  other element agrees to 2e-6;
* Adam's ``mu`` to 1e-7 absolute plus 1e-4 relative and ``nu`` to 1e-12
  absolute plus 1e-4 relative of each element: they are gradients (and
  their squares) that agree to about 1e-6 relative, and an element whose
  gradient is near zero carries the absolute term;
* the optimizer alone, on one fixed gradient tree, to 1e-7 absolute on
  the params and 1e-6 relative on the moments: the same float32
  elementwise arithmetic, apart from the float32 power in the bias
  correction and the schedule.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.training import loss as jloss
from progen_tpu.training import optimizer as joptimizer
from progen_tpu.training import step as jstep
from progen_tpu.training.state import TrainState as JTrainState
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.convert import (
    flax_opt_state_to_torch,
    flax_params_to_state_dict,
    torch_opt_state_to_flax,
)
from progen_tpu_torch.ops import cuda_attention
from progen_tpu_torch.training import loss as tloss
from progen_tpu_torch.training import optimizer as toptimizer
from progen_tpu_torch.training.step import (
    batch_loss,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from progen_tpu_torch.training.state import TrainState

CFG = dict(num_tokens=32, dim=64, seq_len=32, depth=3, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
           dtype="float32")
STEPS, ACCUM, MICRO = 3, 2, 2
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _jax_params(seed: int = 0) -> dict:
    """JAX init, as numpy, with SGU weights/biases and norm scales
    redrawn so every parameter matters at this size."""
    cfg = jcfg.ProGenConfig(**CFG)
    params = flax.linen.meta.unbox(jax.jit(JProGen(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.seq_len), jnp.int32)
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


def _batches(seed: int = 1) -> np.ndarray:
    """(STEPS, ACCUM, MICRO, seq_len + 1) tokens; every other sequence
    ends in padding."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 32, (STEPS, ACCUM, MICRO, 33)).astype(np.int32)
    for s in range(STEPS):
        toks[s, :, 1, 20 + 3 * s:] = 0
    return toks


def _port_state(tree: dict, remat: bool) -> TrainState:
    cfg = ProGenConfig(remat=remat, **CFG)
    state = init_train_state(
        cfg, toptimizer.OptimizerConfig(2e-4, 1e-3, 0.5), device="cpu")
    state.model.load_state_dict(flax_params_to_state_dict(tree, cfg))
    return state


def _jax_run(tree: dict, batches, remat: bool):
    """The JAX package's train step from ``tree``: (states after each
    step, metrics of each step), as numpy."""
    cfg = jcfg.ProGenConfig(remat=remat, **CFG)
    model = JProGen(cfg)
    opt = joptimizer.make_optimizer(2e-4, 1e-3, 0.5)
    state = JTrainState.create(jax.tree.map(jnp.asarray, tree), opt)
    step = jax.jit(jstep.make_train_step(model, opt))
    states, metrics = [], []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def tree():
    return _jax_params()


@pytest.fixture(scope="module", params=[False, True], ids=["remat_off",
                                                           "remat_on"])
def trajectories(request, tree):
    """Both packages' 3-step trajectories from the same weights and
    batches, with remat off and on."""
    remat = request.param
    batches = _batches()
    jstates, jmetrics = _jax_run(tree, batches, remat)
    state = _port_state(tree, remat)
    step = make_train_step()
    tstates, tmetrics = [], []
    for b in batches:
        state, m = step(state, torch.from_numpy(b))
        tstates.append((
            {k: v.clone() for k, v in state.model.state_dict().items()},
            {k: (v if k == "count" else {n: t.clone() for n, t in v.items()})
             for k, v in state.optimizer.state_dict().items()},
            state.step))
        tmetrics.append({k: v.item() for k, v in m.items()})
    return jstates, jmetrics, tstates, tmetrics


def _assert_tree_close(got_sd: dict, want_tree: dict, cfg, **tol):
    want = flax_params_to_state_dict(want_tree, cfg)
    assert got_sd.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got_sd[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


class TestLoss:
    def test_cross_entropy_matches_jax(self):
        rng = np.random.default_rng(2)
        logits = rng.standard_normal((3, 2, 16, 32)).astype(np.float32) * 3
        targets = rng.integers(1, 32, (3, 2, 16))
        targets[0, 1, 5:] = 0
        targets[2, 0, 9:] = 0
        j = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
        t = tloss.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets))
        assert t.shape == (3, 2)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)

    def test_batch_loss_shifts_and_averages(self, tree):
        state = _port_state(tree, remat=False)
        data = torch.from_numpy(_batches()[0, 0]).long()
        with torch.no_grad():
            got = batch_loss(state.model, data)
            logits = state.model(data[:, :-1])
        want = tloss.cross_entropy(logits, data[:, 1:]).mean()
        assert got.item() == want.item()
        assert make_eval_step()(state, data).item() == got.item()


class TestOptimizer:
    """MaskedAdamW + clip against optax over 5 updates on fixed gradient
    trees, with the clip both active and idle."""

    @pytest.mark.parametrize("schedule", ["constant", "cosine"])
    def test_five_updates_match_optax(self, tree, schedule):
        kw = (dict(schedule="cosine", warmup_steps=2, total_steps=6)
              if schedule == "cosine" else {})
        jopt = joptimizer.make_optimizer(1e-2, 1e-1, 0.5, **kw)
        topt_cfg = toptimizer.OptimizerConfig(1e-2, 1e-1, 0.5, **kw)
        cfg = ProGenConfig(**CFG)
        model = ProGen(cfg, device="cpu", seed=None)
        model.load_state_dict(flax_params_to_state_dict(tree, cfg))
        opt = toptimizer.MaskedAdamW(model, topt_cfg)
        params = jax.tree.map(jnp.asarray, tree)
        jstate = jopt.init(params)
        rng = np.random.default_rng(3)
        for i in range(5):
            # global norms from about 0.1 (clip idle) to 10 (clip active)
            g = jax.tree.map(
                lambda p: (rng.standard_normal(p.shape) * 10.0 ** (i - 3)
                           ).astype(np.float32), tree)
            grads = flax_params_to_state_dict(g, cfg)
            assert toptimizer.learning_rate(topt_cfg, i) == pytest.approx(
                float(optax.warmup_cosine_decay_schedule(
                    0.0, 1e-2, 2, 6, 1e-3)(i)) if schedule == "cosine"
                else 1e-2, rel=1e-6, abs=1e-12)
            opt.update(grads)
            upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      params)
            params = optax.apply_updates(params, upd)
        _assert_tree_close(model.state_dict(),
                           jax.tree.map(np.asarray, params), cfg,
                           atol=1e-7, rtol=0)
        want = flax_opt_state_to_torch(jax.tree.map(np.asarray, jstate), cfg)
        assert opt.count == want["count"] == 5
        for key in ("mu", "nu"):
            for name, t in want[key].items():
                np.testing.assert_allclose(opt.state_dict()[key][name],
                                           t.numpy(), rtol=1e-6, atol=0,
                                           err_msg=f"{key} {name}")

    def test_warmup_first_update_has_lr_zero(self, tree):
        cfg = toptimizer.OptimizerConfig(schedule="cosine", warmup_steps=3,
                                         total_steps=10)
        assert toptimizer.learning_rate(cfg, 0) == 0.0
        model = ProGen(ProGenConfig(**CFG), device="cpu", seed=0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = toptimizer.MaskedAdamW(model, cfg)
        opt.update({n: torch.ones_like(p) for n, p in opt.params.items()})
        assert opt.count == 1
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert float(opt.mu["embed"].abs().sum()) > 0

    def test_cosine_ends_at_a_tenth_of_peak(self):
        cfg = toptimizer.OptimizerConfig(1.0, schedule="cosine",
                                         warmup_steps=2, total_steps=10)
        assert toptimizer.learning_rate(cfg, 2) == pytest.approx(1.0)
        assert toptimizer.learning_rate(cfg, 10) == pytest.approx(0.1)
        assert toptimizer.learning_rate(cfg, 50) == pytest.approx(0.1)

    def test_bad_schedules_raise(self):
        with pytest.raises(ValueError, match="unknown schedule"):
            toptimizer.OptimizerConfig(schedule="linear")
        with pytest.raises(ValueError, match="total_steps"):
            toptimizer.OptimizerConfig(schedule="cosine", warmup_steps=5,
                                       total_steps=5)

    def test_clip_has_no_epsilon(self):
        g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
        toptimizer.clip_by_global_norm(g, 1.0)
        assert torch.equal(g["a"], torch.tensor([3.0, 4.0]) / 5.0 * 1.0)
        g = {"a": torch.tensor([0.3, 0.4])}  # under the limit: untouched
        toptimizer.clip_by_global_norm(g, 1.0)
        assert torch.equal(g["a"], torch.tensor([0.3, 0.4]))

    def test_decay_mask_is_rank_two_and_up(self):
        model = ProGen(ProGenConfig(**CFG), device="cpu", seed=0)
        mask = toptimizer.weight_decay_mask(dict(model.named_parameters()))
        assert mask["ff.2.sgu.spatial_weights"]
        assert mask["ff.2.sgu.spatial_biases"]  # (n, 1)
        assert mask["embed"] and mask["attn.0.to_qkv.weight"]
        assert not mask["attn.0.norm.scale"]
        assert not mask["attn.0.to_out.bias"]


class TestTrainStep:
    def test_loss_and_grad_norm_match_jax(self, trajectories):
        _, jm, _, tm = trajectories
        for j, t in zip(jm, tm):
            for key in ("loss", "last_micro_loss", "grad_norm"):
                np.testing.assert_allclose(t[key], j[key], rtol=LOSS_RTOL,
                                           err_msg=key)
            assert t["skipped"] == j["skipped"] == 0

    def test_params_match_jax_after_each_step(self, trajectories):
        js, _, ts, _ = trajectories
        cfg = ProGenConfig(**CFG)
        for i, (j, (sd, _, step)) in enumerate(zip(js, ts)):
            assert step == int(j.step) == i + 1
            _assert_tree_close(sd, j.params, cfg, atol=PARAM_ATOL, rtol=0)

    def test_adam_moments_and_count_match_jax(self, trajectories):
        js, _, ts, _ = trajectories
        cfg = ProGenConfig(**CFG)
        for j, (_, opt, _) in zip(js, ts):
            want = flax_opt_state_to_torch(j.opt_state, cfg)
            assert opt["count"] == want["count"]
            for key, atol in (("mu", 1e-7), ("nu", 1e-12)):
                for name, t in want[key].items():
                    np.testing.assert_allclose(opt[key][name].numpy(),
                                               t.numpy(), rtol=1e-4,
                                               atol=atol,
                                               err_msg=f"{key} {name}")

    def test_loss_falls_on_a_repeated_batch(self, tree):
        state = _port_state(tree, remat=False)
        state.optimizer = toptimizer.MaskedAdamW(
            state.model, toptimizer.OptimizerConfig(1e-2))
        batch = torch.from_numpy(_batches()[0])
        step = make_train_step()
        first = step(state, batch)[1]["loss"].item()
        for _ in range(3):
            last = step(state, batch)[1]["loss"].item()
        assert last < first

    def test_finite_gate_matches_jax(self, tree):
        """Weights poisoned with a NaN: both packages refuse the update
        (params, moments and count unchanged) but advance the step."""
        poisoned = jax.tree.map(np.copy, tree)
        poisoned["to_logits"]["bias"][3] = np.nan
        batches = _batches()[:1]
        js, jm = _jax_run(poisoned, batches, remat=False)
        state = _port_state(poisoned, remat=False)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, m = make_train_step()(state, torch.from_numpy(batches[0]))
        assert int(m["skipped"]) == int(jm[0]["skipped"]) == 1
        assert np.isnan(m["loss"].item()) and np.isnan(jm[0]["loss"])
        assert state.step == int(js[0].step) == 1
        assert state.optimizer.count == int(
            flax_opt_state_to_torch(js[0].opt_state,
                                    ProGenConfig(**CFG))["count"]) == 0
        for k, v in state.model.state_dict().items():
            assert torch.equal(v.nan_to_num(), before[k].nan_to_num()), k
        for moments in (state.optimizer.mu, state.optimizer.nu):
            assert all(float(t.abs().sum()) == 0 for t in moments.values())

    def test_batch_must_have_an_accumulation_axis(self, tree):
        state = _port_state(tree, remat=False)
        with pytest.raises(ValueError, match="grad_accum"):
            make_train_step()(state, torch.zeros(2, 33, dtype=torch.long))


class TestRemat:
    def test_remat_on_and_off_give_equal_gradients(self, tree):
        data = torch.from_numpy(_batches()[0, 0]).long()
        grads = []
        for remat in (False, True):
            model = _port_state(tree, remat).model
            batch_loss(model, data).backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        for name, g in grads[0].items():
            assert torch.equal(g, grads[1][name]), name

    def test_remat_recomputes_each_block_forward(self, tree, monkeypatch):
        calls = []
        real = cuda_attention.local_attention_fwd

        def counting(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(cuda_attention, "local_attention_fwd", counting)
        data = torch.from_numpy(_batches()[0, 0]).long()
        for remat, forwards in ((False, 3), (True, 6)):
            calls.clear()
            model = _port_state(tree, remat).model
            batch_loss(model, data).backward()
            assert len(calls) == forwards
        calls.clear()
        with torch.no_grad():  # no recompute without autograd
            batch_loss(model, data)
        assert len(calls) == 3


class TestOptStateBridge:
    @pytest.mark.parametrize("scan", [False, True])
    def test_round_trip_is_bit_equal(self, trajectories, scan):
        js, _, _, _ = trajectories
        cfg = ProGenConfig(**CFG)
        port = flax_opt_state_to_torch(js[-1].opt_state, cfg)
        back = torch_opt_state_to_flax(port, cfg, scan_layers=scan)
        again = flax_opt_state_to_torch(back, cfg)
        assert back["count"].dtype == np.int32
        assert again["count"] == port["count"] == STEPS
        for key in ("mu", "nu"):
            for name, t in port[key].items():
                assert torch.equal(again[key][name], t), (key, name)
        if not scan:  # the unrolled tree equals the JAX one leaf by leaf
            adam = js[-1].opt_state[1][0]
            for key in ("mu", "nu"):
                a = jax.tree_util.tree_leaves_with_path(back[key])
                b = dict(jax.tree_util.tree_leaves_with_path(
                    getattr(adam, key)))
                assert len(a) == len(b)
                for path, leaf in a:
                    assert np.array_equal(leaf, b[path]), path

    def test_loads_into_the_port_optimizer(self, trajectories, tree):
        js, _, _, _ = trajectories
        cfg = ProGenConfig(**CFG)
        state = _port_state(tree, remat=False)
        state.optimizer.load_state_dict(
            flax_opt_state_to_torch(js[0].opt_state, cfg))
        assert state.optimizer.count == 1
        got = torch_opt_state_to_flax(state.optimizer.state_dict(), cfg)
        want = flax_opt_state_to_torch(js[0].opt_state, cfg)
        for name, t in flax_params_to_state_dict(got["nu"], cfg).items():
            assert torch.equal(t, want["nu"][name])

    def test_missing_adam_state_raises(self):
        with pytest.raises(ValueError, match="Adam"):
            flax_opt_state_to_torch(({"a": 1},), ProGenConfig(**CFG))


class TestEntryPoint:
    def test_init_train_state_raises_without_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(ProGenConfig(**CFG))

    def test_init_train_state_is_fresh(self):
        state = init_train_state(ProGenConfig(**CFG), device="cpu", seed=5)
        assert state.step == 0 and state.optimizer.count == 0
        assert state.num_params() == ProGenConfig(**CFG).num_params()
        assert state.optimizer.config == toptimizer.OptimizerConfig()
        ref = ProGen(ProGenConfig(**CFG), device="cpu", seed=5)
        for k, v in ref.state_dict().items():
            assert torch.equal(state.model.state_dict()[k], v), k
