"""The plain versions of the port's kernels against the TPU kernels they
replace, run in Pallas interpret mode on the CPU, plus the wrappers'
dispatch rules.

A1 ``local_attention_fwd`` vs ``pallas_local_attention`` (forward
``_fwd_kernel``), L1 ``norm_shift`` vs ``fused_norm_shift``, L2
``sgu_mix_gate`` vs ``fused_sgu_mix_gate``, each in float32 and bfloat16.
The gradients: A2 ``local_attention_bwd_kv_reference`` and A3
``local_attention_bwd_halo_reference`` vs ``jax.vjp`` of
``pallas_local_attention`` with ``bwd_impl="kv"`` / ``"halo"`` (bodies
``_bwd_kv_kernel_batched`` and ``_bwd_kernel``), and L1's and L2's
``autograd.Function``s vs ``jax.vjp`` of the fused layers.
Tolerances: float32 to 1e-5 (summation order); bfloat16 to 2^-7
relative plus 2^-7 absolute (two bfloat16 ulps of values near 1: each
side rounds once from float32 sums taken in different orders), the
gradients too. The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.ops.pallas_attention import pallas_local_attention
from progen_tpu.ops.pallas_layers import fused_norm_shift, fused_sgu_mix_gate
from progen_tpu_torch.ops import cuda_attention, cuda_layers
from progen_tpu_torch.ops.dispatch import check_same_device, takes_kernel
from torch_sgu_split import split_mix

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -7, rtol=2 ** -7)}
EPS = 1e-5
WRAPPERS = ("local_attention_fwd", "local_attention_bwd_kv",
            "local_attention_bwd_halo")


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _close(j, t, dtype):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j.astype(jnp.float32)), **TOL[dtype])


def _counts():
    return tuple(getattr(cuda_attention, n).launches for n in WRAPPERS) + (
        cuda_layers.norm_shift.launches, cuda_layers.sgu_mix_gate.launches)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """On the CPU no wrapper launches a kernel, so no count moves."""
    before = _counts()
    yield
    assert _counts() == before


class TestLocalAttentionFwd:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("window", [8, 16])
    def test_matches_pallas_forward(self, dtype, window):
        rng = np.random.default_rng(10)
        q, k, v = (rng.standard_normal((2, 2, 32, 16), np.float32)
                   for _ in range(3))
        (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
        j = pallas_local_attention(jq, jk, jv, window, None, True, "kv", 1,
                                   "pallas")
        t = cuda_attention.local_attention_fwd(tq, tk, tv, window)
        assert t.dtype == tq.dtype
        _close(j, t, dtype)

    def test_explicit_scale(self):
        rng = np.random.default_rng(11)
        q, k, v = (rng.standard_normal((1, 2, 16, 16), np.float32)
                   for _ in range(3))
        (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32")
                                        for a in (q, k, v))
        j = pallas_local_attention(jq, jk, jv, 8, 0.3, True, "kv", 1,
                                   "pallas")
        _close(j, cuda_attention.local_attention_fwd(tq, tk, tv, 8, 0.3),
               "float32")

    def test_pv_in_float32_unlike_plain_attention(self):
        """The kernel's plain version (like the TPU kernel and the float32
        FMA kernel on the card) keeps P in float32 for P·V; the plain
        attention op rounds P to bfloat16 first. The two differ in
        bfloat16. (The bfloat16 kernel on the card carries P as two
        bfloat16 parts:
        ``TestTensorCoreRounding.test_split_p_forward_within_card_tolerance``.)"""
        from progen_tpu_torch.ops.attention import local_attention

        rng = np.random.default_rng(12)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 2, 64, 16), np.float32)).bfloat16() for _ in range(3))
        a = cuda_attention.local_attention_fwd(q, k, v, 16)
        b = local_attention(q, k, v, window_size=16)
        ref = cuda_attention.local_attention_fwd(q.float(), k.float(),
                                                 v.float(), 16)
        assert not torch.equal(a, b)
        assert (a.float() - ref).abs().mean() <= (b.float() - ref).abs().mean()


def _attention_inputs(dtype, window, seed=20):
    rng = np.random.default_rng(seed + window)
    arrays = [rng.standard_normal((2, 2, 32, 16), np.float32)
              for _ in range(4)]
    return [_pair(a, dtype) for a in arrays]  # q, k, v, dO


class TestLocalAttentionBwd:
    @pytest.mark.parametrize("impl", ["kv", "halo"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("window", [8, 16])
    def test_matches_pallas_backward(self, impl, dtype, window):
        (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _attention_inputs(
            dtype, window)
        _, vjp = jax.vjp(
            lambda q, k, v: pallas_local_attention(q, k, v, window, None,
                                                   True, impl, 1, "pallas"),
            jq, jk, jv)
        want = vjp(jdo)
        ref = getattr(cuda_attention,
                      f"local_attention_bwd_{impl}_reference")
        got = ref(tq, tk, tv, tdo, window)
        for j, t, like in zip(want, got, (tq, tk, tv)):
            assert t.dtype == like.dtype and t.shape == like.shape
            _close(j, t, dtype)

    @pytest.mark.parametrize("window", [8, 16])
    def test_kv_halo_and_autograd_agree(self, window):
        """The two plain backwards, the autograd of the plain forward and
        the differentiable op all give one gradient (float32)."""
        (_, q), (_, k), (_, v), (_, do) = _attention_inputs("float32",
                                                            window, 21)
        kv = cuda_attention.local_attention_bwd_kv_reference(q, k, v, do,
                                                             window)
        halo = cuda_attention.local_attention_bwd_halo_reference(q, k, v, do,
                                                                 window)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(
            cuda_attention.local_attention_fwd_reference(*leaves, window),
            leaves, do)
        for impl, want in (("kv", kv), ("halo", halo)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = cuda_attention.local_attention(*leaves, window,
                                                 bwd_impl=impl)
            got = torch.autograd.grad(out, leaves, do)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        for a, b, c in zip(kv, halo, auto):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)

    def test_phantom_key_gradients_do_not_leak(self):
        """Window 0's phantom keys get a non-zero gradient in the halo
        scratch (their probability is not 0); the combine drops it, and
        the kv structure never forms it: window 0's dk and dv are the same
        with and without a phantom-key gradient in the scratch."""
        (_, q), (_, k), (_, v), (_, do) = _attention_inputs("float32", 8, 22)
        w, nw = 8, 4
        d2 = torch.randn(2, 2, nw, 2 * w, 16,
                         generator=torch.Generator().manual_seed(0))
        combined = cuda_attention._halo_combine(d2, w)
        poked = d2.clone()
        poked[:, :, 0, :w] += 100.0
        assert torch.equal(cuda_attention._halo_combine(poked, w), combined)
        torch.testing.assert_close(combined[:, :, :w],
                                   d2[:, :, 0, w:] + d2[:, :, 1, :w])
        torch.testing.assert_close(combined[:, :, -w:], d2[:, :, -1, w:])
        # the phantom keys' own gradient, which the combine drops
        qw = q.reshape(2, 2, nw, w, 16)[:, :, 0]
        k2 = torch.cat((torch.zeros_like(qw), k[:, :, :w]), dim=2)
        p = cuda_attention._softmax_rows(qw, k2, w, 16 ** -0.5)
        dv_phantom = cuda_attention._t_product(p, do[:, :, :w])[:, :, :w]
        assert float(dv_phantom.abs().sum()) > 1.0
        dq, dk, dv = cuda_attention.local_attention_bwd_kv_reference(
            q, k, v, do, w)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(
            cuda_attention.local_attention_fwd_reference(*leaves, w),
            leaves, do)
        for g, a in zip((dq, dk, dv), auto):
            torch.testing.assert_close(g[:, :, :w], a[:, :, :w], atol=1e-5,
                                       rtol=1e-5)

    @pytest.mark.parametrize("bad", ["kv_g2", "xla", "KV"])
    def test_unknown_bwd_impl_raises_at_the_call(self, bad):
        q = torch.zeros(1, 1, 16, 16)
        with pytest.raises(ValueError, match="bwd_impl"):
            cuda_attention.local_attention(q, q, q, 8, bwd_impl=bad)


class TestLayerGradients:
    """L1's and L2's backward: autograd of the plain composition through
    their autograd.Functions, against jax.vjp of the fused layers (whose
    backward differentiates the same composition)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_norm_shift_grads_match_jax(self, dtype):
        rng = np.random.default_rng(23)
        x = (rng.standard_normal((2, 32, 33)) * 2 + 0.5).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 33).astype(np.float32)
        g = rng.standard_normal((2, 32, 33)).astype(np.float32)
        (jx, tx), (jg, tg) = _pair(x, dtype), _pair(g, dtype)
        jd, td = DTYPES[dtype]
        _, vjp = jax.vjp(
            lambda a, s: fused_norm_shift(a, s, EPS, 16, True,
                                          jnp.dtype(jd).name),
            jx, jnp.asarray(scale))
        want = vjp(jg)
        leaves = [tx.clone().requires_grad_(True),
                  torch.from_numpy(scale).requires_grad_(True)]
        out = cuda_layers.norm_shift(*leaves, EPS, td)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, tg)
        _close(want[0], got[0], dtype)
        # the scale's gradient sums 64 rows: relative to its size
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=TOL[dtype]["rtol"],
                                   atol=TOL[dtype]["atol"] * 8)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sgu_mix_gate_grads_match_jax(self, dtype):
        rng = np.random.default_rng(24)
        x, gate, g = (rng.standard_normal((2, 32, 24), np.float32)
                      for _ in range(3))
        w = (rng.standard_normal((32, 32)) / np.sqrt(32)).astype(np.float32)
        b = rng.standard_normal((32, 1)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
        (jx, tx), (jgate, tgate), (jg, tg) = (_pair(a, dtype)
                                             for a in (x, gate, g))
        jd, td = DTYPES[dtype]
        _, vjp = jax.vjp(
            lambda *a: fused_sgu_mix_gate(*a, EPS, 16, True,
                                          jnp.dtype(jd).name),
            jx, jgate, jnp.asarray(w), jnp.asarray(b), jnp.asarray(scale))
        want = vjp(jg)
        leaves = [t.clone().requires_grad_(True) for t in
                  (tx, tgate, torch.from_numpy(w), torch.from_numpy(b),
                   torch.from_numpy(scale))]
        out = cuda_layers.sgu_mix_gate(*leaves, EPS, td)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, leaves, tg)
        names = ("x", "gate", "W", "b", "scale")
        for j, t, leaf, name in zip(want, got, leaves, names):
            assert t.dtype == leaf.dtype
            ref = np.asarray(j.astype(jnp.float32))
            # W, b and scale sum over batch and channels: their tolerance
            # is relative to the largest gradient of the tensor
            atol = TOL[dtype]["atol"] * (1 if name in ("x", "gate")
                                         else max(1.0, np.abs(ref).max()))
            np.testing.assert_allclose(t.float().numpy(), ref,
                                       rtol=TOL[dtype]["rtol"], atol=atol,
                                       err_msg=name)


class TestNormShift:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [32, 33])
    def test_matches_pallas(self, dtype, d):
        rng = np.random.default_rng(13)
        x = (rng.standard_normal((2, 32, d)) * 2 + 0.5).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
        jx, tx = _pair(x, dtype)
        jd, td = DTYPES[dtype]
        j = fused_norm_shift(jx, jnp.asarray(scale), EPS, 16, True,
                             jnp.dtype(jd).name)
        t = cuda_layers.norm_shift(tx, torch.from_numpy(scale), EPS, td)
        assert t.dtype == td
        _close(j, t, dtype)

    def test_row_zero_shifted_half_is_zero(self):
        x = torch.randn(2, 8, 10, generator=torch.Generator().manual_seed(0))
        out = cuda_layers.norm_shift(x, torch.ones(10), EPS, torch.float32)
        assert torch.all(out[:, 0, :5] == 0)
        assert torch.all(out[:, 0, 5:] != 0)


class TestSguMixGate:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas(self, dtype):
        rng = np.random.default_rng(14)
        x, gate = (rng.standard_normal((2, 32, 24), np.float32)
                   for _ in range(2))
        # weights at 1/sqrt(n), so the mix is not hidden under the bias
        w = (rng.standard_normal((32, 32)) / np.sqrt(32)).astype(np.float32)
        b = rng.standard_normal((32, 1)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
        (jx, tx), (jg, tg) = _pair(x, dtype), _pair(gate, dtype)
        jd, td = DTYPES[dtype]
        j = fused_sgu_mix_gate(jx, jg, jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(scale), EPS, 16, True,
                               jnp.dtype(jd).name)
        t = cuda_layers.sgu_mix_gate(tx, tg, torch.from_numpy(w),
                                     torch.from_numpy(b),
                                     torch.from_numpy(scale), EPS, td)
        assert t.dtype == td
        _close(j, t, dtype)

    def test_gate_rounded_before_mix(self):
        """In bfloat16 the gate is normalised and rounded before the mix:
        skipping the rounding gives another result."""
        g = torch.Generator().manual_seed(1)
        x = torch.randn(1, 16, 8, generator=g).bfloat16()
        gate = torch.randn(1, 16, 8, generator=g).bfloat16()
        w = torch.randn(16, 16, generator=g) / 4
        b = torch.zeros(16, 1)
        s = torch.ones(8)
        out = cuda_layers.sgu_mix_gate(x, gate, w, b, s, EPS, torch.bfloat16)
        gn = cuda_layers.norm_reference(gate, s, EPS, torch.float32)
        unrounded = x * (torch.einsum("bnd,mn->bmd", gn, torch.tril(w))
                         + b).bfloat16()
        assert not torch.equal(out, unrounded)


class TestTensorCoreRounding:
    """The numerical departures of the bfloat16/float16 kernels on the
    card's tensor cores, where the TPU kernel keeps P and dS in float32:
    the backwards (A2, A3, A4's) round P and dS to the input dtype before
    the dV, dK and dQ products; the forward (A1, A4's) carries P into P·V
    as two input-dtype parts, its rounding and the rounded remainder.
    Written out here, on the plain composition, and held against the TPU
    kernel's output and gradient at the card tests' bfloat16 tolerance
    (1e-2 + 1e-2 * |want|)."""

    @staticmethod
    def _tc_forward(q, k, v, w, split=True, tile=64):
        """The forward as the tensor-core kernel takes it, in float32
        before the output's rounding: per window, the previous window's
        keys and then its own, each range cut into ``tile``-key tiles from
        its own start, through an online softmax in base 2 (scores scaled
        by scale * log2(e)); each tile's P, exp2(s - m) in float32, enters
        P·V as bfloat16 hi + lo (hi = P rounded, lo = P - hi rounded; with
        ``split=False``, hi alone), and l is summed from the float32 P.
        Window 0 starts at max 0 and denominator w (the phantom keys) and
        sees no previous keys."""
        c = q.shape[-1] ** -0.5 * 1.4426950408889634
        qw, kw, vw = (cuda_attention._windows(t, w) for t in (q, k, v))
        nw = qw.shape[2]
        first = (torch.arange(nw) == 0)[:, None]  # (nw, 1)
        m = torch.where(first, 0.0, -torch.inf).expand(*qw.shape[:-1])
        l = torch.where(first, float(w), 0.0).expand(*qw.shape[:-1])
        acc = torch.zeros_like(qw)
        a = torch.arange(w)[:, None]  # the row within its window
        prev_k = torch.cat((torch.zeros_like(kw[:, :, :1]), kw[:, :, :-1]), 2)
        prev_v = torch.cat((torch.zeros_like(vw[:, :, :1]), vw[:, :, :-1]), 2)
        for ks, vs, own in ((prev_k, prev_v, False), (kw, vw, True)):
            for t0 in range(0, w, tile):
                j = torch.arange(t0, min(t0 + tile, w))[None, :]
                kt, vt = ks[..., t0:t0 + tile, :], vs[..., t0:t0 + tile, :]
                s = torch.einsum("...id,...jd->...ij", qw, kt) * c
                vis = (j <= a) if own else ~first[..., None]
                s = s.masked_fill(~vis, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1))
                ms = torch.where(m_new == -torch.inf, 0.0, m_new)
                corr = torch.exp2(m - ms)
                p = torch.exp2(s - ms[..., None])
                l = l * corr + p.sum(-1)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float() if split else 0 * hi
                acc = acc * corr[..., None] + torch.einsum(
                    "...ij,...jd->...id", hi, vt) + torch.einsum(
                    "...ij,...jd->...id", lo, vt)
                m = m_new
        return (acc * (1 / l)[..., None]).reshape(q.shape)

    def test_split_p_forward_within_card_tolerance(self):
        w = 128
        rng = np.random.default_rng(31)
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal((2, 2, 256, 64), np.float32),
                  "bfloat16") for _ in range(3))
        want = pallas_local_attention(jq, jk, jv, w, None, True, "kv", 1,
                                      "pallas")
        got = self._tc_forward(tq, tk, tv, w)
        once = self._tc_forward(tq, tk, tv, w, split=False)
        exact = cuda_attention.local_attention_fwd_reference(
            tq.float(), tk.float(), tv.float(), w)
        # the split carries P about 8 bits further than one rounding
        assert (got - exact).abs().max() * 16 < (once - exact).abs().max()
        for t in (got.bfloat16(), exact.bfloat16()):
            np.testing.assert_allclose(
                t.float().numpy(), np.asarray(want.astype(jnp.float32)),
                atol=1e-2, rtol=1e-2)

    @staticmethod
    def _rounded_backward(q, k, v, do, w):
        from progen_tpu_torch.ops.attention import with_prev_window

        scale = q.shape[-1] ** -0.5
        qw, kw, vw, dow = (cuda_attention._windows(t, w)
                           for t in (q, k, v, do))
        k2, v2 = with_prev_window(kw, None), with_prev_window(vw, None)
        p = cuda_attention._softmax_rows(qw, k2, w, scale)
        ds = cuda_attention._ds(p, dow, v2)
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dq = torch.einsum("...ij,...jd->...id", ds, k2) * scale
        dk2 = cuda_attention._t_product(ds, qw) * scale
        dv2 = cuda_attention._t_product(p, dow)
        return (dq.reshape(q.shape),
                cuda_attention._halo_combine(dk2, w),
                cuda_attention._halo_combine(dv2, w))

    def test_rounded_p_and_ds_within_card_tolerance(self):
        w = 64
        rng = np.random.default_rng(30)
        (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
            _pair(rng.standard_normal((2, 2, 128, 64), np.float32),
                  "bfloat16") for _ in range(4))
        _, vjp = jax.vjp(
            lambda q, k, v: pallas_local_attention(q, k, v, w, None, True,
                                                   "kv", 1, "pallas"),
            jq, jk, jv)
        want = vjp(jdo)
        got = self._rounded_backward(tq, tk, tv, tdo, w)
        exact = cuda_attention.local_attention_bwd_halo_reference(
            tq.float(), tk.float(), tv.float(), tdo.float(), w)
        for j, t, e in zip(want, got, exact):
            assert not torch.equal(t, e)  # the rounding is a real change
            np.testing.assert_allclose(
                t.numpy(), np.asarray(j.astype(jnp.float32)), atol=1e-2,
                rtol=1e-2)


class TestSplitWeightMix:
    """L2's bfloat16 kernel on the card's tensor cores: the gate
    normalised and rounded to bfloat16 (as the TPU kernel rounds it), W
    zeroed above the diagonal and split into two bfloat16 parts, hi =
    bf16(W) and lo = bf16(W - hi), and the mix summed in float32 over
    tiles of 32 j from j = 0, each tile adding hi·g and then lo·g (every
    product of two bfloat16 values is exact in float32). Written out in
    tests/torch_sgu_split.py (which the card's test holds the kernel
    against too) and held here against the TPU kernel in interpret mode,
    whole and for a
    shard's rows at an offset, at the bfloat16 tolerance of this file
    (two ulps of values near 1)."""

    @pytest.mark.parametrize("row0,rows", [(0, 96), (40, 30)])
    def test_split_w_within_one_ulp(self, row0, rows):
        rng = np.random.default_rng(32)
        n, d = 96, 24
        x, gate = (rng.standard_normal((2, n, d), np.float32)
                   for _ in range(2))
        # weights at 1/sqrt(n), so the mix is not hidden under the bias
        w = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)
        b = rng.standard_normal((n, 1)).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
        (jx, tx), (jg, tg) = _pair(x, "bfloat16"), _pair(gate, "bfloat16")
        want = fused_sgu_mix_gate(jx, jg, jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(scale), EPS, 32, True,
                                  "bfloat16")[:, row0:row0 + rows]
        sl = slice(row0, row0 + rows)
        args = (tx[:, sl], tg, torch.from_numpy(w[sl]),
                torch.from_numpy(b[sl]), torch.from_numpy(scale), EPS, row0)
        got, mix = split_mix(*args)
        _, once = split_mix(*args, split=False)
        g = cuda_layers.norm_reference(tg, torch.from_numpy(scale), EPS,
                                       torch.bfloat16).float()
        exact = torch.tril(torch.from_numpy(w))[sl] @ g
        # the split carries W about 8 bits further than one rounding
        assert (mix - exact).abs().max() * 16 < (once - exact).abs().max()
        assert got.dtype == torch.bfloat16
        _close(want, got, "bfloat16")


class TestDispatch:
    def test_cpu_tensor_takes_plain_version(self):
        assert not takes_kernel(torch.zeros(1))

    def test_other_devices_raise(self):
        with pytest.raises(RuntimeError):
            takes_kernel(torch.zeros(1, device="meta"))

    def test_operands_on_several_devices_raise(self):
        check_same_device(torch.zeros(1), torch.ones(2))
        with pytest.raises(ValueError, match="several devices"):
            check_same_device(torch.zeros(1), torch.zeros(1, device="meta"))

    def test_kernel_sources_present(self):
        from progen_tpu_torch.ops import _build

        for name in _build.KERNELS:
            assert (_build.CSRC / f"{name}.cu").is_file()
        assert _build.KERNELS == ("local_attention_bwd_halo",
                                  "local_attention_bwd_kv",
                                  "local_attention_fwd", "norm_shift",
                                  "sgu_mix_gate")

    def test_library_name_follows_sources(self, tmp_path, monkeypatch):
        from progen_tpu_torch.ops import _build

        a = _build._library_path("norm_shift")
        monkeypatch.setattr(_build, "NVCC_FLAGS",
                            _build.NVCC_FLAGS + ("-DX",))
        assert _build._library_path("norm_shift") != a

    def test_missing_nvcc_raises(self, monkeypatch):
        from progen_tpu_torch.ops import _build

        monkeypatch.setattr(_build.shutil, "which", lambda _: None)
        monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.nvcc()
