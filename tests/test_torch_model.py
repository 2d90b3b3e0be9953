"""The port's model, decoder, scoring, sampling and weight bridge against
the JAX package, at a small size on the CPU.

Config: dim 64, depth 3 (2 uniform layers + 1 gMLP layer), heads 2,
dim_head 16, window 8, seq_len 32, ff_mult 2, vocab 32. Weights come from
the JAX model's init, with the SGU weights and biases and the norm scales
redrawn from numpy (at init the SGU mix is ~1e-3/n and would hide a
fault), and go to the port through ``convert.py``.

Tolerances: float32 logits agree to 1e-4 absolute and relative (three
layers of float32 sums in different orders); bfloat16 logits to 0.1
absolute (a few bfloat16 ulps of logits of size ~3, after every layer
rounds activations where either framework may round differently).
"""

import dataclasses
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu import sampling as jsampling
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.models.progen import decode_model, unstack_params
from progen_tpu.workloads.scoring import score_step as jscore_step
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch import sampling as tsampling
from progen_tpu_torch.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from progen_tpu_torch.workloads.scoring import score_step

CFG = dict(num_tokens=32, dim=64, seq_len=32, depth=3, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.1, rtol=0)


def _jax_params(cfg: jcfg.ProGenConfig, seed: int = 0) -> dict:
    """JAX init, as numpy, with SGU weights/biases and norm scales redrawn
    so every parameter matters at this size."""
    params = flax.linen.meta.unbox(jax.jit(JProGen(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.seq_len), jnp.int32)
    )["params"])
    rng = np.random.default_rng(seed)
    n = cfg.seq_len

    def redraw(path, leaf):
        names = [p.key for p in path]
        a = np.asarray(leaf)
        if names[-1] == "spatial_weights":
            return (rng.standard_normal(a.shape) / np.sqrt(n)).astype(a.dtype)
        if names[-1] == "spatial_biases":
            return rng.standard_normal(a.shape).astype(a.dtype)
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


def _port(tree: dict, dtype: str) -> ProGen:
    cfg = ProGenConfig(dtype=dtype, **CFG)
    model = ProGen(cfg, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(tree, cfg))
    return model.eval()


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, port model) in float32 and in bfloat16."""
    out = {}
    tree = _jax_params(jcfg.ProGenConfig(**CFG))
    for dtype in ("float32", "bfloat16"):
        jm = JProGen(jcfg.ProGenConfig(dtype=dtype, **CFG))
        out[dtype] = (jm, tree, _port(tree, dtype))
    return out


def _tokens(seed=0, batch=2):
    toks = np.random.default_rng(seed).integers(1, 32, (batch, 32))
    toks[1, 20:] = 0
    return toks


class TestForward:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kernel_flags", [False, True])
    def test_logits_match_jax(self, setup, dtype, kernel_flags):
        _, tree, pm = setup[dtype]
        flags = dict(use_pallas_attn=True, use_fused_layer_kernels=True,
                     pallas_layer_block=16) if kernel_flags else {}
        jm = JProGen(jcfg.ProGenConfig(dtype=dtype, **CFG, **flags))
        toks = _tokens()
        jl = np.asarray(jax.jit(jm.apply)({"params": tree},
                                          jnp.asarray(toks)))
        with torch.no_grad():
            tl = pm(torch.from_numpy(toks))
        assert tl.dtype == torch.float32 and tl.shape == (2, 32, 32)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   **(F32 if dtype == "float32" else BF16))

    def test_scan_layers_tree_gives_same_logits(self, setup):
        jm, tree, pm = setup["float32"]
        cfg = jcfg.ProGenConfig(scan_layers=True, dtype="float32", **CFG)
        stacked = state_dict_to_flax_params(pm.state_dict(),
                                            ProGenConfig(**CFG),
                                            scan_layers=True)
        toks = jnp.asarray(_tokens(1))
        a = jax.jit(JProGen(cfg).apply)({"params": stacked}, toks)
        b = jax.jit(jm.apply)({"params": tree}, toks)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    def test_sgu_bound_to_seq_len(self, setup):
        _, _, pm = setup["float32"]
        with pytest.raises(ValueError):
            pm(torch.zeros(1, 16, dtype=torch.long))

    def test_seeded_init_is_reproducible(self):
        cfg = ProGenConfig(**CFG)
        a, b = ProGen(cfg, device="cpu", seed=3), ProGen(cfg, device="cpu",
                                                         seed=3)
        c = ProGen(cfg, device="cpu", seed=4)
        for (k, x), y, z in zip(a.state_dict().items(),
                                b.state_dict().values(),
                                c.state_dict().values()):
            assert torch.equal(x, y), k
        assert not torch.equal(a.embed, c.embed)

    def test_init_statistics_follow_flax(self):
        cfg = ProGenConfig(**{**CFG, "dim": 256})
        m = ProGen(cfg, device="cpu", seed=0)
        sd = m.state_dict()
        assert abs(sd["embed"].std().item() - 0.02 * 0.88) < 0.003
        assert sd["embed"].abs().max() <= 0.04 + 1e-6
        w = sd["attn.0.to_qkv.weight"]  # lecun normal, fan_in = dim
        assert abs(w.std().item() - 256 ** -0.5) < 0.003
        sw = sd["ff.2.sgu.spatial_weights"]
        assert sw.abs().max() <= 1e-3 / 32
        assert torch.all(sd["ff.2.sgu.spatial_biases"] == 1)
        assert torch.all(sd["norm.scale"] == 1)
        assert torch.all(sd["attn.0.to_out.bias"] == 0)
        assert sum(p.numel() for p in m.parameters()) == cfg.num_params()


class TestDecode:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_matches_full_forward(self, setup, dtype):
        _, _, pm = setup[dtype]
        toks = torch.from_numpy(_tokens(2))
        with torch.no_grad():
            full = pm(toks)
            cache = pm.init_cache(2)
            steps = torch.stack([pm.decode_step(toks[:, p], cache)
                                 for p in range(32)], dim=1)
        assert cache.pos.tolist() == [32, 32]
        np.testing.assert_allclose(steps.numpy(), full.numpy(),
                                   **(F32 if dtype == "float32" else BF16))

    def test_decode_matches_jax_decode(self, setup):
        jm, tree, pm = setup["float32"]
        dm = decode_model(jm)
        params = unstack_params(tree, jm.config)
        toks = _tokens(3)
        cache = dm.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, 1), jnp.int32))["cache"]

        def step(c, t):
            return dm.apply({"params": params, "cache": c}, t,
                            mutable=["cache"])

        step = jax.jit(step)
        tcache = pm.init_cache(2)
        for p in range(32):
            jl, mut = step(cache, jnp.asarray(toks[:, p:p + 1]))
            cache = mut["cache"]
            with torch.no_grad():
                tl = pm.decode_step(torch.from_numpy(toks[:, p]), tcache)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0],
                                       **F32)

    def test_cache_is_updated_in_place(self, setup):
        _, _, pm = setup["float32"]
        cache = pm.init_cache(1)
        ring = cache.attn[0].k
        with torch.no_grad():
            pm.decode_step(torch.tensor([5]), cache)
        assert cache.attn[0].k is ring and ring.abs().sum() > 0
        assert cache.attn[0].slot_pos[0, 0].item() == 0
        assert cache.ff[2].gate_history[:, 0].abs().sum() > 0

    def test_decode_past_seq_len_raises(self, setup):
        _, _, pm = setup["float32"]
        cache = pm.init_cache(1)
        cache.pos = 32
        with pytest.raises(ValueError):
            pm.decode_step(torch.tensor([1]), cache)


class TestScoring:
    def test_score_step_matches_jax(self, setup):
        jm, tree, pm = setup["float32"]
        batch = np.zeros((3, 33), np.int64)
        rng = np.random.default_rng(4)
        for i, n in enumerate((30, 12, 1)):
            batch[i, 1:1 + n] = rng.integers(1, 32, n)
        jn, jlp, jmask = jscore_step(jm, tree, jnp.asarray(batch, jnp.int32))
        tn, tlp, tmask = score_step(pm, batch, device="cpu")
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **F32)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **F32)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))

    def test_model_on_other_device_raises(self, setup):
        _, _, pm = setup["float32"]
        with pytest.raises(ValueError):
            score_step(pm, np.zeros((1, 33), np.int64), device="meta")


def _jax_noise(seed: int, draws: int, vocab: int) -> np.ndarray:
    """The per-draw Gumbel noise of JAX ``sample_fast(PRNGKey(seed))``:
    one split of the running key per draw."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(draws):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jsampling.gumbel_noise(sub, (vocab,))))
    return np.stack(out)


class TestSampling:
    @pytest.mark.parametrize("prime,add_bos,top_k", [
        ([5, 6, 7], True, 25),
        ([3, 9, 4, 11, 2], False, 10),
        ([7], True, None),
    ])
    def test_stream_matches_jax_with_its_noise(self, setup, prime, add_bos,
                                               top_k):
        jm, tree, pm = setup["float32"]
        length = 32
        start = len(prime) + (1 if add_bos else 0)
        noise = _jax_noise(7, length - start, 32)
        j = jsampling.sample_fast(jax.random.PRNGKey(7), jm, tree,
                                  jnp.asarray(prime), length, top_k=top_k,
                                  add_bos=add_bos)
        t = tsampling.sample_fast(0, pm, prime, length, top_k=top_k,
                                  add_bos=add_bos, device="cpu",
                                  noise=lambda i: noise[i])
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    def test_batched_rows_equal_single_decodes(self, setup):
        _, _, pm = setup["bfloat16"]
        primes = [[5, 6, 7], [8, 9, 10], [11, 12, 13]]
        batched = tsampling.sample_fast_batched(11, pm, primes, 32,
                                                add_bos=True, device="cpu")
        for i, prime in enumerate(primes):
            single = tsampling.sample_fast(tsampling.row_seed(11, i), pm,
                                           prime, 32, add_bos=True,
                                           device="cpu")
            assert torch.equal(batched[i], single)
        assert len({tuple(r.tolist()) for r in batched}) > 1

    def test_draw_depends_on_row_seed_and_step_only(self):
        assert tsampling.draw_seed(5, 3) == tsampling.draw_seed(5, 3)
        assert tsampling.draw_seed(5, 3) != tsampling.draw_seed(5, 4)
        assert tsampling.row_seed(5, 0) != tsampling.row_seed(5, 1)
        assert 0 <= tsampling.row_seed(2 ** 70, 1) < 2 ** 63

    def test_noise_comes_from_a_cpu_generator(self):
        """Draw t of a row is the CPU generator's float32 Gumbel noise,
        seeded with draw_seed(row_seed, t), whatever device the logits lie
        on: the draw is made on the CPU and copied to their device
        (tests/test_torch_cuda.py compares the card's copy bit for
        bit)."""
        seeds = [tsampling.row_seed(3, i) for i in range(2)]
        draw = tsampling._seeded_draws(seeds)
        got = draw(5, torch.zeros(2, 32))
        assert got.dtype == torch.float32 and got.shape == (2, 32)
        for row, s in zip(got, seeds):
            gen = torch.Generator().manual_seed(tsampling.draw_seed(s, 5))
            u = torch.rand(32, generator=gen)
            assert torch.equal(row, -torch.log(-torch.log(u + 1e-20)
                                               + 1e-20))
        other = draw(5, torch.zeros(2, 32, device="meta"))
        assert other.device.type == "meta" and other.shape == (2, 32)
        assert torch.equal(draw(5, torch.zeros(2, 32)), got)

    def test_truncates_after_second_zero(self, setup):
        _, _, pm = setup["float32"]
        vocab = 32
        noise = np.zeros((31, vocab), np.float32)
        noise[4, 0] = 1e6  # draw 4 emits EOS
        out = tsampling.sample_fast(0, pm, [5], 32, top_k=None, add_bos=True,
                                    device="cpu", noise=lambda i: noise[i])
        assert out[0] == 0 and out[6] == 0
        assert torch.all(out[2:6] != 0) and torch.all(out[7:] == 0)

    def test_top_k_one_draws_eos(self, setup):
        """With top_k = 1 the parity sampler's strict '>' masks every
        token, so every draw is token 0 (reference behaviour)."""
        _, _, pm = setup["float32"]
        out = tsampling.sample_fast(1, pm, [5, 6], 16, top_k=1,
                                    add_bos=True, device="cpu")
        assert out.tolist() == [0, 5, 6] + [0] * 13

    @pytest.mark.parametrize("logit_seed", [0, 1])
    def test_knob_step_matches_jax(self, logit_seed):
        rng = np.random.default_rng(logit_seed)
        logit = rng.standard_normal((3, 32)).astype(np.float32)
        for parity, temp, top_p in ((True, 1.0, 2.0), (False, 0.7, 0.8)):
            # the JAX step draws its noise from the key's split; the port
            # gets that same noise
            sub = jax.random.split(jax.random.PRNGKey(logit_seed))[1]
            jn = np.array(jsampling.gumbel_noise(sub, (3, 32)))
            _, j = jsampling._gumbel_topk_step(
                jax.random.PRNGKey(logit_seed), jnp.asarray(logit), 5,
                parity, temp, top_p)
            t = tsampling.gumbel_topk_step(torch.from_numpy(logit), 5,
                                           torch.from_numpy(jn), parity,
                                           temp, top_p)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    def test_rejects_bad_requests(self, setup):
        _, _, pm = setup["float32"]
        with pytest.raises(ValueError):
            tsampling.sample_fast(0, pm, [1] * 5, 40, device="cpu")
        with pytest.raises(ValueError):
            tsampling.sample_fast(0, pm, [], 8, device="cpu")
        with pytest.raises(ValueError):
            tsampling.sample_fast(0, pm, [1, 2], 8, temperature=0.0,
                                  device="cpu")


class TestBridge:
    @pytest.mark.parametrize("scan", [False, True])
    def test_round_trip_is_bit_equal(self, scan):
        cfg = jcfg.ProGenConfig(scan_layers=scan, **CFG)
        tree = jax.tree.map(np.asarray, flax.linen.meta.unbox(jax.jit(
            JProGen(cfg).init)(jax.random.PRNGKey(1),
                               jnp.zeros((1, 32), jnp.int32))["params"]))
        tcfg = ProGenConfig(scan_layers=scan, **CFG)
        sd = flax_params_to_state_dict(tree, tcfg)
        back = state_dict_to_flax_params(sd, tcfg)
        a = jax.tree_util.tree_flatten_with_path(tree)[0]
        b = jax.tree_util.tree_flatten_with_path(back)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert np.array_equal(x, y), path

    def test_state_dict_keys_and_layouts(self):
        tree = _jax_params(jcfg.ProGenConfig(**CFG))
        sd = flax_params_to_state_dict(tree, ProGenConfig(**CFG))
        model = ProGen(ProGenConfig(**CFG), device="cpu")
        assert set(sd) == set(model.state_dict())
        # a flax kernel is (in, out); nn.Linear is (out, in)
        np.testing.assert_array_equal(sd["attn.0.to_qkv.weight"].numpy(),
                                      tree["attn0"]["to_qkv"]["kernel"].T)


class TestDevice:
    def test_entry_points_raise_without_card(self, setup, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, _, pm = setup["float32"]
        with pytest.raises(RuntimeError, match="CUDA"):
            ProGen(ProGenConfig(**CFG))
        with pytest.raises(RuntimeError, match="CUDA"):
            score_step(pm, np.zeros((1, 33), np.int64))
        with pytest.raises(RuntimeError, match="CUDA"):
            tsampling.sample_fast(0, pm, [1], 8)

    def test_config_round_trips_through_replace(self):
        c = ProGenConfig(**CFG)
        assert ProGenConfig.from_dict(
            dataclasses.replace(c, decode=True).to_dict()).decode


def test_smoke_script_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a host without
    a card, and alone in a directory without the repo."""
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for cwd, path in ((script.parent, script),
                      (tmp_path, tmp_path / "chip_smoke.py")):
        if path != script:
            path.write_text(script.read_text())
        res = subprocess.run([sys.executable, str(path)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
