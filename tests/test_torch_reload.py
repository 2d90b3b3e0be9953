"""Hot weight reload on the port's engine (``serving/reload.py``,
``ServeEngine.prepare_params``/``commit_params``): the cases of
``tests/test_reload.py`` on the CPU. New weights of the same names,
shapes and dtypes are copied into the served model between decode steps
with no request dropped and every parameter at its old address (the
port's form of the JAX engine's no-recompile swap); anything else (a
flipped or truncated file, an unfinished save, another model's
parameters, a pin to a missing name) is rejected on the background
thread and the served weights stay as they were, bit for bit.

Config: the JAX serving tests' tiny model (vocab 32, dim 32, seq_len
32, depth 2, window 8, one gMLP layer, heads 2, dim_head 16, ff_mult 2,
float32). After a reload onto weights converted from the JAX model's
parameters (``convert.flax_params_to_state_dict``), the port's decode
logits match the JAX decoder's and its embedding the JAX engine's to
1e-5 absolute (the serving tests' tolerance: two layers of float32 sums
in different orders).
"""

import json
import os
import pathlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.models.progen import decode_model
from progen_tpu.serving import ServeEngine as JServeEngine
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.checkpoint import Package, get_checkpoint_fns
from progen_tpu_torch.convert import flax_params_to_state_dict
from progen_tpu_torch.ops.quant import quantize_tree
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.serving import (
    Request,
    Scheduler,
    ServeEngine,
    WeightReloader,
)
from progen_tpu_torch.training.optimizer import MaskedAdamW, OptimizerConfig
from progen_tpu_torch.training.state import TrainState

TINY = dict(num_tokens=32, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
CFG = ProGenConfig(**TINY)
ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """The port model's seeded weights (checkpoint A's)."""
    return ProGen(CFG, device="cpu", seed=0).state_dict()


def _scaled(sd: dict, factor: float) -> dict:
    return {k: v * factor for k, v in sd.items()}


def _name(path: str) -> str:
    return pathlib.Path(path).name


def _save(ck, sd: dict, step: int = 0, cfg: ProGenConfig = CFG) -> str:
    """A checkpoint of ``sd`` written by the port's checkpoint.py."""
    model = ProGen(cfg, device="cpu", seed=None)
    model.load_state_dict(sd)
    state = TrainState(step, model, MaskedAdamW(model, OptimizerConfig()))
    return get_checkpoint_fns(str(ck))[2](Package(
        next_seq_index=0, state=state, model_config=cfg.to_dict(),
        run_id="run"))


def _engine(sd: dict, **kw) -> ServeEngine:
    model = ProGen(CFG, device="cpu", seed=None)
    model.load_state_dict(sd)
    return ServeEngine(model.eval(), max_slots=2, max_len=24, **kw)


def _live(engine) -> dict:
    return {k: v.clone() for k, v in engine.model.state_dict().items()}


def _ptrs(engine) -> dict:
    return {k: v.data_ptr() for k, v in engine.model.state_dict().items()}


def _reload(reloader):
    """Start the background load and wait for it; the commit stays the
    caller's."""
    assert reloader.request_reload()
    reloader.join(120)


def _publish(path: pathlib.Path, text: str) -> None:
    """Write a control file as its writer must: a .tmp sibling, fsynced,
    then renamed over the name (a reader never sees a torn pin)."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _assert_weights(engine, sd: dict) -> None:
    for k, v in engine.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


class TestPackagePath:
    def test_restore_and_peek_report_source_dir(self, tmp_path, weights):
        """Reload decides "is this new?" by the checkpoint directory's
        name, so every restore reports where it read from."""
        saved = _save(tmp_path / "ck", weights)
        get_last = get_checkpoint_fns(str(tmp_path / "ck"))[1]
        assert _name(get_last.restore_params().path) == _name(saved)
        assert _name(get_last.peek().path) == _name(saved)


class TestHotSwap:
    def test_swap_under_live_traffic_in_place_no_drops(self, tmp_path,
                                                      weights):
        """Serve from A, stage B mid-decode, commit between steps: every
        request completes, each parameter keeps its address, the model
        ends on B's weights, and a request admitted after the commit is
        sample_fast's under B."""
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        engine = _engine(weights)
        sched = Scheduler(engine)
        for i in range(3):
            ok, reason = sched.submit(Request(
                id=f"r{i}", prime=np.asarray([3 + i, 5]), length=20,
                seed=60 + i))
            assert ok, reason
        for _ in range(3):
            sched.step()
        ptrs = _ptrs(engine)
        params_b = _scaled(weights, 1.5)
        name_b = _name(_save(ck, params_b, step=1))
        reloader = WeightReloader(engine, ck, metrics=sched.metrics,
                                  current=name_a)
        _reload(reloader)
        assert reloader.maybe_commit() == name_b
        assert reloader.current == name_b and reloader.last_error is None
        assert reloader.last_duration_s > 0
        assert _ptrs(engine) == ptrs  # copied in place
        ok, reason = sched.submit(Request(id="after", prime=np.asarray(
            [7, 2, 9]), length=22, seed=5))
        assert ok, reason
        _, comp = sched.run_to_completion(max_steps=200)
        done = {c.request_id: c for c in comp}
        assert sorted(done) == ["after", "r0", "r1", "r2"]  # none dropped
        _assert_weights(engine, params_b)
        want = sample_fast(5, engine.model, np.asarray([7, 2, 9]), 22,
                           device="cpu").numpy()
        np.testing.assert_array_equal(done["after"].tokens, want)
        assert sched.metrics.counters["reloads"] == 1
        assert sched.metrics.counters["reload_rejected"] == 0
        assert sched.metrics.snapshot()["reload_duration_s_count"] == 1

    def test_reload_onto_current_checkpoint_is_rejected(self, tmp_path,
                                                        weights):
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        reloader = WeightReloader(_engine(weights), ck, current=name_a)
        _reload(reloader)
        assert reloader.maybe_commit() is None
        assert reloader.last_error == "no_new_checkpoint"

    def test_empty_store_is_rejected(self, tmp_path, weights):
        reloader = WeightReloader(_engine(weights), tmp_path / "nothing")
        _reload(reloader)
        assert reloader.maybe_commit() is None
        assert reloader.last_error == "no_checkpoint"

    def test_int8_engine_requantizes_on_commit(self, tmp_path, weights):
        """An int8 engine must not serve new weights against stale
        tables: the commit swaps the parameters, the int8 weights and
        scales, and the calibration report together."""
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        engine = _engine(weights, quantize_int8=True)
        q_before, report_before = engine._q_params, engine.quant_report
        assert report_before["quantized_leaves"] > 0
        params_b = _scaled(weights, 1.5)
        _save(ck, params_b, step=1)
        reloader = WeightReloader(engine, ck, current=name_a)
        _reload(reloader)
        assert reloader.maybe_commit() is not None
        assert engine._q_params is not q_before
        assert engine.quant_report is not report_before
        assert engine.quant_report["quantized_leaves"] == \
            report_before["quantized_leaves"]
        q_want, s_want, _ = quantize_tree(params_b, CFG)
        for k in s_want:
            torch.testing.assert_close(engine._q_params[k], q_want[k],
                                       rtol=0, atol=0)
            torch.testing.assert_close(engine._q_scales[k], s_want[k],
                                       rtol=0, atol=0)

    def test_reload_onto_jax_weights_matches_the_jax_engine(self, tmp_path,
                                                            weights):
        """A reload onto weights converted from the JAX model's params:
        the port's decode logits and embedding against the JAX decoder's
        and engine's on the same weights."""
        jm = JProGen(jcfg.ProGenConfig(**TINY))
        tree = flax.linen.meta.unbox(jax.jit(jm.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 32), jnp.int32))["params"])
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        engine = _engine(weights)
        ptrs = _ptrs(engine)
        name_b = _name(_save(ck, flax_params_to_state_dict(tree, CFG),
                             step=1))
        reloader = WeightReloader(engine, ck, current=name_a)
        _reload(reloader)
        assert reloader.maybe_commit() == name_b
        assert _ptrs(engine) == ptrs
        toks = np.random.default_rng(4).integers(1, 32, 12)
        cache = engine.model.init_cache(1)
        with torch.no_grad():
            got = np.stack([engine.model.decode_step(
                torch.tensor([int(t)]), cache)[0].numpy() for t in toks])
        dm = decode_model(jm)
        params = jax.tree.map(jnp.asarray, tree)
        jcache = dm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 1), jnp.int32))["cache"]
        def one(c, t):
            logits, mut = dm.apply({"params": params, "cache": c},
                                   t[None, None], mutable=["cache"])
            return logits[0, 0], mut["cache"]

        step = jax.jit(one)
        for i, t in enumerate(toks):
            logits, jcache = step(jcache, jnp.int32(t))
            np.testing.assert_allclose(got[i], np.asarray(logits),
                                       atol=ATOL, rtol=0)
        prime = toks[:9]
        want = JServeEngine(jm, tree, max_slots=1).embed(prime,
                                                         add_bos=True)
        np.testing.assert_allclose(engine.embed(prime, add_bos=True),
                                   np.asarray(want), atol=ATOL, rtol=0)


class TestRejectionPaths:
    """Every bad checkpoint is refused on the background thread; the
    served weights are bit-equal before and after the attempt."""

    def _on_a(self, tmp_path, weights):
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        engine = _engine(weights)
        return ck, engine, WeightReloader(engine, ck, current=name_a)

    @staticmethod
    def _files(ckpt_dir):
        return sorted(f for f in pathlib.Path(ckpt_dir).iterdir()
                      if f.suffix == ".pt" and f.stat().st_size > 0)

    def _assert_quarantined(self, ck, reloader, engine, before):
        _reload(reloader)
        assert reloader.maybe_commit() is None
        # the digest walk quarantined B and fell back to A == current
        assert reloader.last_error == "no_new_checkpoint"
        assert any(p.name.endswith(".corrupt")
                   for p in pathlib.Path(ck).iterdir())
        _assert_weights(engine, before)

    def test_flipped_byte_quarantined_params_untouched(self, tmp_path,
                                                      weights):
        ck, engine, reloader = self._on_a(tmp_path, weights)
        target = _save(ck, _scaled(weights, 2.0), step=1)
        victim = self._files(target)[0]
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))
        self._assert_quarantined(ck, reloader, engine, _live(engine))

    def test_truncated_file_quarantined_params_untouched(self, tmp_path,
                                                        weights):
        ck, engine, reloader = self._on_a(tmp_path, weights)
        target = _save(ck, _scaled(weights, 0.5), step=1)
        victim = max(self._files(target), key=lambda f: f.stat().st_size)
        victim.write_bytes(victim.read_bytes()[:victim.stat().st_size // 2])
        self._assert_quarantined(ck, reloader, engine, _live(engine))

    def test_missing_meta_is_invisible_not_quarantined(self, tmp_path,
                                                       weights):
        """No meta.json means the save never finished: the walk skips
        the directory (it may be mid-write) instead of condemning it."""
        ck, engine, reloader = self._on_a(tmp_path, weights)
        target = pathlib.Path(_save(ck, _scaled(weights, 0.5), step=1))
        (target / "meta.json").unlink()
        _reload(reloader)
        assert reloader.maybe_commit() is None
        assert reloader.last_error == "no_new_checkpoint"
        assert target.exists()
        assert not any(p.name.endswith(".corrupt")
                       for p in pathlib.Path(ck).iterdir())

    def test_incompatible_tree_rejected(self, tmp_path, weights):
        """Another architecture's checkpoint is never swapped in: the
        compatibility check refuses it by name and shape."""
        other = ProGenConfig(**{**TINY, "dim": 16, "dim_head": 8})
        ck = tmp_path / "ck"
        _save(ck, ProGen(other, device="cpu", seed=1).state_dict(),
              cfg=other)
        engine = _engine(weights)
        before = _live(engine)
        reloader = WeightReloader(engine, ck)
        _reload(reloader)
        assert reloader.maybe_commit() is None
        assert "incompatible" in reloader.last_error
        _assert_weights(engine, before)


class TestPins:
    """The deploy controller's per-replica seam: a ``reload.pin`` file
    overrides newest-wins watching, and every pin outcome is answered
    through the adjacent ``reload.pin.ack``."""

    def _two(self, tmp_path, weights):
        """Checkpoints A and B on disk, the engine serving B."""
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        params_b = _scaled(weights, 1.5)
        name_b = _name(_save(ck, params_b, step=1))
        engine = _engine(params_b)
        pin = tmp_path / "reload.pin"
        reloader = WeightReloader(engine, ck, current=name_b, pin_path=pin)
        return ck, name_a, name_b, engine, pin, reloader

    @staticmethod
    def _ack(pin):
        return json.loads(pin.with_name(pin.name + ".ack").read_text())

    def test_pin_to_older_checkpoint_commits_and_acks(self, tmp_path,
                                                     weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        _publish(pin, name_a + "\n")
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() == name_a
        assert reloader.current == name_a
        _assert_weights(engine, weights)
        ack = self._ack(pin)
        assert ack["pin"] == name_a and ack["status"] == "committed"

    def test_pin_to_missing_name_rejected_weights_untouched(self, tmp_path,
                                                           weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        before = _live(engine)
        _publish(pin, "ckpt_99999999\n")
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() is None
        assert reloader.last_error == "pin_unavailable"
        assert reloader.current == name_b
        _assert_weights(engine, before)
        ack = self._ack(pin)
        assert ack == {**ack, "pin": "ckpt_99999999", "status": "rejected",
                       "reason": "pin_unavailable"}

    def test_rejected_pin_not_retried_until_it_changes(self, tmp_path,
                                                       weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        _publish(pin, "ckpt_99999999\n")
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() is None
        assert reloader.poll_watch(0.0) is False  # the same bad pin
        _publish(pin, name_a + "\n")
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() == name_a

    def test_pin_overrides_newest_wins(self, tmp_path, weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        _save(ck, _scaled(weights, 0.5), step=2)  # newer, but pinned to B
        _publish(pin, name_b + "\n")
        assert reloader.poll_watch(0.0) is False
        assert reloader.current == name_b
        ack = self._ack(pin)  # a satisfied pin is still answered
        assert ack["pin"] == name_b and ack["status"] == "committed"

    def test_pin_removal_resumes_newest_wins(self, tmp_path, weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        _publish(pin, name_b + "\n")
        assert reloader.poll_watch(0.0) is False
        name_c = _name(_save(ck, _scaled(weights, 0.5), step=2))
        assert reloader.poll_watch(0.0) is False  # still pinned
        pin.unlink()
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() == name_c

    def test_startup_pin_answered_without_reload(self, tmp_path, weights):
        ck, name_a, name_b, engine, pin, reloader = self._two(tmp_path,
                                                              weights)
        _publish(pin, name_b + "\n")
        reloader.note_startup_pin()
        ack = self._ack(pin)
        assert ack["pin"] == name_b and ack["status"] == "committed"
        _publish(pin, "ckpt_99999999\n")
        reloader.note_startup_pin()
        ack = self._ack(pin)
        assert ack["status"] == "rejected"
        assert ack["reason"] == "pin_unavailable_at_startup"
        assert reloader.poll_watch(0.0) is False  # not retried hot


class TestWatcher:
    def test_poll_watch_kicks_on_new_checkpoint(self, tmp_path, weights):
        ck = tmp_path / "ck"
        name_a = _name(_save(ck, weights))
        reloader = WeightReloader(_engine(weights), ck, current=name_a)
        assert reloader.poll_watch(0.0) is False  # nothing newer
        name_b = _name(_save(ck, _scaled(weights, 1.5), step=1))
        assert reloader.poll_watch(0.0) is True
        reloader.join(120)
        assert reloader.maybe_commit() == name_b
        assert reloader.poll_watch(0.0) is False  # already current
