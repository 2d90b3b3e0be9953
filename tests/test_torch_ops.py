"""The port's plain ops, config, tokenizer and loss against the JAX package.

Inputs come from numpy with fixed seeds and go through both frameworks
on the CPU. Tolerances: float32 results agree to 1e-5 (the two
frameworks sum in different orders); bfloat16 results to 2^-7 relative
plus 2^-7 absolute (two bfloat16 ulps: both round once from float32 at
points where the other may round differently); pure data movement is
exact.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu.data import tokenizer as jtok
from progen_tpu.ops import attention as jattn
from progen_tpu.ops import pallas_layers as jlayers
from progen_tpu.ops import rotary as jrot
from progen_tpu.ops import sgu as jsgu
from progen_tpu.ops import shift as jshift
from progen_tpu.training import loss as jloss
from progen_tpu_torch import config as tcfg
from progen_tpu_torch.data import tokenizer as ttok
from progen_tpu_torch.ops import attention as tattn
from progen_tpu_torch.ops import cuda_layers as tlayers
from progen_tpu_torch.ops import rotary as trot
from progen_tpu_torch.ops import sgu as tsgu
from progen_tpu_torch.ops import shift as tshift
from progen_tpu_torch.training import loss as tloss

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -7, rtol=2 ** -7)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(j, t, dtype):
    np.testing.assert_allclose(_np(t), _np(j), **TOL[dtype])


class TestConfig:
    @pytest.mark.parametrize(
        "path", sorted((REPO / "configs" / "model").glob("*.toml")),
        ids=lambda p: p.stem,
    )
    def test_every_model_config_loads_alike(self, path):
        jc = jcfg.ProGenConfig.from_dict(jcfg.load_toml_config(str(path)))
        tc = tcfg.ProGenConfig.from_dict(tcfg.load_toml_config(str(path)))
        assert tc.to_dict() == jc.to_dict()
        assert tc.num_params() == jc.num_params()

    def test_base_config_size(self):
        c = tcfg.ProGenConfig.from_dict(tcfg.load_toml_config(
            str(REPO / "configs" / "model" / "base.toml")))
        assert (c.dim, c.depth, c.heads, c.dim_head, c.window_size,
                c.seq_len, c.global_mlp_depth) == (1024, 24, 16, 64, 512,
                                                   1024, 2)
        assert 400e6 < c.num_params() < 402e6

    def test_window_must_divide_seq_len(self):
        with pytest.raises(ValueError):
            tcfg.ProGenConfig(seq_len=100, window_size=64)

    def test_dtypes(self):
        c = tcfg.ProGenConfig()
        assert c.compute_dtype == torch.bfloat16
        assert c.params_dtype == torch.float32


class TestTokenizer:
    @pytest.mark.parametrize("text", ["MKTAYIAKQR", "", "# MK?LV", "ÅÖ"])
    def test_encode_decode_match(self, text):
        np.testing.assert_array_equal(ttok.encode_tokens(text),
                                      jtok.encode_tokens(text))
        toks = np.concatenate([[0], jtok.encode_tokens(text), [0, 0]])
        assert ttok.decode_tokens(toks) == jtok.decode_tokens(toks)


class TestRotary:
    def test_tables_match(self):
        js, jc = jrot.fixed_pos_embedding(48, 16, offset=3)
        ts, tc = trot.fixed_pos_embedding(48, 16, offset=3)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("rot_dim", [16, 8])
    def test_apply_matches(self, dtype, rot_dim):
        x = np.random.default_rng(0).standard_normal((2, 3, 24, 16),
                                                     np.float32)
        jx, tx = _pair(x, dtype)
        js, jc = jrot.fixed_pos_embedding(24, rot_dim)
        ts, tc = trot.fixed_pos_embedding(24, rot_dim)
        _close(jrot.apply_rotary_pos_emb(jx, js, jc),
               trot.apply_rotary_pos_emb(tx, ts, tc), dtype)

    def test_rotate_every_two_exact(self):
        x = np.arange(12, dtype=np.float32).reshape(2, 6)
        np.testing.assert_array_equal(
            trot.rotate_every_two(torch.from_numpy(x)).numpy(),
            np.asarray(jrot.rotate_every_two(jnp.asarray(x))))


class TestShift:
    @pytest.mark.parametrize("d", [8, 7])
    def test_matches_exactly(self, d):
        x = np.random.default_rng(1).standard_normal((2, 5, d), np.float32)
        np.testing.assert_array_equal(
            tshift.shift_tokens(torch.from_numpy(x)).numpy(),
            np.asarray(jshift.shift_tokens(jnp.asarray(x))))

    def test_shift_state_matches(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 1, 7), np.float32)
        st = rng.standard_normal((2, 1, 4), np.float32)
        np.testing.assert_array_equal(
            tshift.shift_tokens(torch.from_numpy(x),
                                torch.from_numpy(st)).numpy(),
            np.asarray(jshift.shift_tokens(jnp.asarray(x),
                                           jnp.asarray(st))))


class TestLocalAttention:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("window", [4, 8])
    def test_matches(self, dtype, window):
        rng = np.random.default_rng(3)
        q, k, v = (rng.standard_normal((2, 2, 32, 16), np.float32)
                   for _ in range(3))
        (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
        _close(jattn.local_attention(jq, jk, jv, window_size=window),
               tattn.local_attention(tq, tk, tv, window_size=window), dtype)

    def test_first_prev_window_matches(self):
        rng = np.random.default_rng(4)
        q, k, v = (rng.standard_normal((1, 2, 16, 8), np.float32)
                   for _ in range(3))
        hk, hv = (rng.standard_normal((1, 2, 4, 8), np.float32)
                  for _ in range(2))
        j = jattn.local_attention(
            *(jnp.asarray(a) for a in (q, k, v)), window_size=4,
            first_prev_k=jnp.asarray(hk), first_prev_v=jnp.asarray(hv))
        t = tattn.local_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), window_size=4,
            first_prev_k=torch.from_numpy(hk),
            first_prev_v=torch.from_numpy(hv))
        _close(j, t, "float32")

    def test_phantom_keys_dilute_window_zero(self):
        """Window 0 matches the dense reference with w phantom zero keys,
        not a softmax over the real keys alone."""
        rng = np.random.default_rng(5)
        q, k, v = (rng.standard_normal((1, 1, 16, 8), np.float32)
                   for _ in range(3))
        dense = jattn.dense_local_attention_reference(
            *(jnp.asarray(a) for a in (q, k, v)), window_size=4)
        t = tattn.local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window_size=4)
        _close(dense, t, "float32")

    def test_rejects_ragged_sequence(self):
        x = torch.zeros(1, 1, 10, 8)
        with pytest.raises(ValueError):
            tattn.local_attention(x, x, x, window_size=4)


class TestSguMix:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("block", [0, 8])
    def test_matches(self, dtype, block):
        rng = np.random.default_rng(6)
        gate = rng.standard_normal((2, 32, 16), np.float32)
        w = (rng.standard_normal((32, 32)) / 32).astype(np.float32)
        b = rng.standard_normal((32, 1)).astype(np.float32)
        jg, tg = _pair(gate, dtype)
        _close(jsgu.causal_sgu_mix(jg, jnp.asarray(w), jnp.asarray(b), block),
               tsgu.causal_sgu_mix(tg, torch.from_numpy(w),
                                   torch.from_numpy(b), block), dtype)

    def test_causal(self):
        rng = np.random.default_rng(7)
        gate = torch.from_numpy(rng.standard_normal((1, 16, 4), np.float32))
        w = torch.from_numpy(rng.standard_normal((16, 16), np.float32))
        b = torch.zeros(16, 1)
        base = tsgu.causal_sgu_mix(gate, w, b)
        gate2 = gate.clone()
        gate2[:, 9:] += 1.0
        out = tsgu.causal_sgu_mix(gate2, w, b)
        torch.testing.assert_close(out[:, :9], base[:, :9], atol=0, rtol=0)


class TestNormReference:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches(self, dtype):
        rng = np.random.default_rng(8)
        x = (rng.standard_normal((2, 8, 24)) * 3 + 1).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
        jx, tx = _pair(x, dtype)
        jd, td = DTYPES[dtype]
        _close(jlayers.norm_reference(jx, jnp.asarray(scale), 1e-5, jd),
               tlayers.norm_reference(tx, torch.from_numpy(scale), 1e-5, td),
               dtype)

    def test_differs_from_torch_layer_norm_formula(self):
        """The variance is E[x^2] - E[x]^2 clamped at 0: a constant row
        with a large offset normalises to the flax result, 0."""
        x = torch.full((1, 16), 1000.0)
        out = tlayers.norm_reference(x, torch.ones(16), 1e-5, torch.float32)
        assert torch.all(out == 0)


class TestLoss:
    def _batch(self):
        rng = np.random.default_rng(9)
        logits = rng.standard_normal((3, 12, 20)).astype(np.float32)
        targets = rng.integers(1, 20, (3, 12))
        targets[0, 7:] = 0
        targets[1, 3:] = 0
        return logits, targets

    def test_sequence_scores_match(self):
        logits, targets = self._batch()
        jn, jlp, jm = jloss.sequence_scores(jnp.asarray(logits),
                                            jnp.asarray(targets))
        tn, tlp, tm = tloss.sequence_scores(torch.from_numpy(logits),
                                            torch.from_numpy(targets))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))

    def test_mask_keeps_first_pad(self):
        t = torch.tensor([[5, 6, 0, 0, 0]])
        assert tloss.eos_loss_mask(t).tolist() == [[True, True, True, False,
                                                    False]]

    def test_masked_mean_all(self):
        _, targets = self._batch()
        vals = np.arange(36, dtype=np.float32).reshape(3, 12)
        mask = targets != 0
        np.testing.assert_allclose(
            tloss.masked_mean(torch.from_numpy(vals),
                              torch.from_numpy(mask)).item(),
            float(jloss.masked_mean(jnp.asarray(vals), jnp.asarray(mask))),
            rtol=1e-6)
