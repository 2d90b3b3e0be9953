"""The port's int8 weight quantisation (``ops/quant.py``) and int8 serving
(``ServeEngine(quantize_int8=True)``) on the CPU, against the JAX
package.

Config: the JAX serving tests' tiny model (vocab 32, dim 32, seq_len 32,
depth 2, window 8, one gMLP layer, heads 2, dim_head 16, ff_mult 2) in
float32, every weight drawn from numpy with a seed into the JAX tree's
shapes and carried to the port through ``convert.py``.

Held: the int8 weights bit-equal to the JAX package's (transposed) and
the scales equal, the same set of leaves, the calibration reports equal
leaf by leaf (``max_abs_err`` to one float32 ulp); the dequantised
weights equal; the int8 engine's streams bit-equal to ``sample_fast`` on
a model loaded with the dequantised weights; its calibration logit gap
within 1e-4 of the JAX engine's on the same weights (float32 decoders
that agree to ~1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.ops import quant as jquant
from progen_tpu.serving import ServeEngine as JServeEngine
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch.convert import flax_params_to_state_dict
from progen_tpu_torch.ops import quant
from progen_tpu_torch.sampling import sample_fast
from progen_tpu_torch.serving import Request, Scheduler, ServeEngine
from test_torch_workloads import make_pair

TINY = dict(num_tokens=32, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")


@pytest.fixture(scope="module")
def pair():
    return make_pair(TINY, seed=3)


def _jax_flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _dequantized_model(pm, engine) -> ProGen:
    """A model loaded with the engine's dequantised weights."""
    model = ProGen(pm.config, device="cpu", seed=None)
    model.load_state_dict(quant.dequantize_tree(
        engine._q_params, engine._q_scales, pm.config.compute_dtype))
    return model.eval()


def _requests() -> list:
    rng = np.random.RandomState(4)
    knobs = [{}, {"temperature": 0.7}, {"top_p": 0.9}, {"top_k": 5},
             {"add_bos": True}]
    return [Request(id=f"q{i}", prime=rng.randint(1, 32, 2 + i % 4),
                    length=int(rng.randint(12, 30)), seed=50 + i,
                    **knobs[i % len(knobs)]) for i in range(6)]


class TestQuantizeTree:
    def test_int8_weights_and_scales_are_the_jax_packages(self, pair):
        _, tree, pm = pair
        cfg = pm.config
        q_state, scales, report = quant.quantize_tree(pm.state_dict(), cfg)
        jq, jscales, jreport = jquant.quantize_tree(tree)
        jq = _jax_flat(jq)
        paths = quant.quantized_leaves(cfg)
        assert sorted(paths.values()) == sorted(jscales)
        assert len(paths) == len(jreport) == 10
        for key, path in paths.items():
            assert q_state[key].dtype == torch.int8
            np.testing.assert_array_equal(q_state[key].numpy(),
                                          jq[path].T)
            np.testing.assert_array_equal(scales[key].numpy(),
                                          np.asarray(jscales[path]))
        for key, t in q_state.items():
            if key not in scales:
                assert t is pm.state_dict()[key] or torch.equal(
                    t, pm.state_dict()[key])
        want = {r["path"]: r for r in jreport}
        for leaf in report:
            w = want[leaf["path"]]
            assert leaf["shape"] == w["shape"]
            assert (leaf["bytes_fp"], leaf["bytes_int8"]) == \
                (w["bytes_fp"], w["bytes_int8"])
            np.testing.assert_allclose(
                leaf["max_abs_err"], w["max_abs_err"], rtol=0,
                atol=float(np.spacing(np.float32(w["max_abs_err"]))))

    def test_leaves_left_in_full_precision(self, pair):
        _, _, pm = pair
        keys = set(quant.quantized_leaves(pm.config))
        assert all(k.endswith(".weight") for k in keys)
        for k in ("embed", "norm.scale", "to_logits.bias",
                  "ff.1.sgu.spatial_weights", "ff.1.sgu.spatial_biases",
                  "attn.0.norm.scale"):
            assert k not in keys
        assert "ff.1.sgu.proj_out.weight" in keys

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dequantize_matches_jax(self, pair, dtype):
        _, tree, pm = pair
        q_state, scales, _ = quant.quantize_tree(pm.state_dict(), pm.config)
        jq, jscales, _ = jquant.quantize_tree(tree)
        tdt = getattr(torch, dtype)
        got = quant.dequantize_tree(q_state, scales, tdt)
        want = _jax_flat(jquant.dequantize_tree(jq, jscales,
                                                getattr(jnp, dtype)))
        for key, path in quant.quantized_leaves(pm.config).items():
            assert got[key].dtype == tdt
            np.testing.assert_array_equal(
                got[key].float().numpy(),
                np.asarray(want[path], np.float32).T)
        assert got["embed"] is q_state["embed"]

    def test_zero_channel_keeps_scale_one(self):
        w = torch.zeros(3, 4)
        w[1] = torch.tensor([0.5, -1.0, 0.25, 0.0])
        q, scale, err = quant.quantize_leaf(w)
        jq, jscale, jerr = jquant.quantize_leaf(jnp.asarray(w.numpy().T))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        assert scale[0] == scale[2] == 1 / 127 and float(err) == float(jerr)


class TestInt8Engine:
    def test_calibration_matches_the_jax_engine(self, pair):
        jm, tree, pm = pair
        engine = ServeEngine(pm, max_slots=2, quantize_int8=True)
        jengine = JServeEngine(jm, tree, max_slots=1, quantize_int8=True)
        got, want = engine.quant_report, jengine.quant_report
        for k in ("bits", "scheme", "quantized_leaves", "bytes_fp",
                  "bytes_int8"):
            assert got[k] == want[k], k
        assert got["logits_max_abs_err"] > 0
        np.testing.assert_allclose(got["logits_max_abs_err"],
                                   want["logits_max_abs_err"], atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(got["weight_max_abs_err"],
                                   want["weight_max_abs_err"], rtol=1e-6)
        assert sorted(leaf["path"] for leaf in got["leaves"]) == \
            sorted(leaf["path"] for leaf in want["leaves"])
        assert engine.quantized_nbytes == got["bytes_int8"]

    @pytest.mark.parametrize("slots", [1, 3])
    def test_streams_equal_sample_fast_on_dequantized_weights(self, pair,
                                                              slots):
        _, _, pm = pair
        engine = ServeEngine(pm, max_slots=slots, quantize_int8=True)
        deq = _dequantized_model(pm, engine)
        sched = Scheduler(engine, prefill_chunk=3)
        reqs = _requests()
        for r in reqs:
            assert sched.submit(r) == (True, None)
        _, comps = sched.run_to_completion(max_steps=2000)
        got = {c.request_id: c.tokens for c in comps}
        for r in reqs:
            want = sample_fast(r.seed, deq, r.prime, r.length,
                               top_k=r.top_k, add_bos=r.add_bos,
                               temperature=r.temperature, top_p=r.top_p,
                               device="cpu").numpy()
            np.testing.assert_array_equal(got[r.id], want, err_msg=r.id)

    def test_decode_runs_the_dequantized_weights(self, pair):
        _, _, pm = pair
        engine = ServeEngine(pm, max_slots=2, quantize_int8=True)
        deq = _dequantized_model(pm, engine)
        toks = torch.tensor([3, 17])
        with torch.inference_mode():
            caches = [m.init_cache(2) for m in (pm, deq, pm)]
            got = engine._decoder()(toks, caches[0])
            want = deq.decode_step(toks, caches[1])
            full = pm.decode_step(toks, caches[2])
        assert torch.equal(got, want)
        assert not torch.equal(got, full)
        assert torch.equal(caches[0].attn[0].k, caches[1].attn[0].k)

    def test_weight_swap_quantizes_and_calibrates_again(self, pair):
        _, _, pm = pair
        model = ProGen(pm.config, device="cpu", seed=None)
        model.load_state_dict(pm.state_dict())
        engine = ServeEngine(model.eval(), max_slots=1, quantize_int8=True)
        before = engine.quant_report
        other = ProGen(pm.config, device="cpu", seed=11).state_dict()
        prepared = engine.prepare_params(other)
        assert engine.quant_report is before  # nothing applied yet
        engine.commit_params(prepared)
        assert engine.quant_report is prepared.quant_report
        assert engine.quant_report["logits_max_abs_err"] != \
            before["logits_max_abs_err"]
        want = quant.quantize_tree(other, pm.config)[0]
        for k, v in engine._q_scales.items():
            assert torch.equal(engine._q_params[k], want[k])
        r = _requests()[0]
        engine.prefill(0, r.prime, r.length, seed=r.seed)
        while engine.slots.live.any():
            engine.decode_step()
        np.testing.assert_array_equal(
            engine.collect(0),
            sample_fast(r.seed, _dequantized_model(pm, engine), r.prime,
                        r.length, device="cpu").numpy())

    def test_embedding_reads_the_full_precision_weights(self, pair):
        _, _, pm = pair
        prime = np.array([4, 9, 2, 7])
        got = ServeEngine(pm, max_slots=1, quantize_int8=True).embed(prime)
        np.testing.assert_array_equal(
            got, ServeEngine(pm, max_slots=1).embed(prime))

    def test_bf16_compute_dequantizes_into_bf16(self):
        cfg = ProGenConfig(**{**TINY, "dtype": "bfloat16"})
        pm = ProGen(cfg, device="cpu", seed=2).eval()
        engine = ServeEngine(pm, max_slots=1, quantize_int8=True)
        deq = engine._dequantized(engine._q_params, engine._q_scales)
        assert all(v.dtype == torch.bfloat16 for v in deq.values())
        model = _dequantized_model(pm, engine)
        r = Request(id="b", prime=np.array([3, 5]), length=20, seed=8)
        engine.prefill(0, r.prime, r.length, seed=r.seed)
        while engine.slots.live.any():
            engine.decode_step()
        np.testing.assert_array_equal(
            engine.collect(0),
            sample_fast(8, model, r.prime, r.length, device="cpu").numpy())


def test_bridge_weights_are_unchanged_by_quantization(pair):
    _, tree, pm = pair
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    quant.quantize_tree(pm.state_dict(), pm.config)
    ServeEngine(pm, max_slots=1, quantize_int8=True)
    want = flax_params_to_state_dict(tree, ProGenConfig(**TINY))
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]) and torch.equal(v, want[k]), k
