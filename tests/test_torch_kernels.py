"""The plain versions of the port's kernels against the TPU kernels they
replace, run in Pallas interpret mode on the CPU, plus the wrappers'
dispatch rules.

A1 ``local_attention_fwd`` vs ``pallas_local_attention`` (forward
``_fwd_kernel``), L1 ``norm_shift`` vs ``fused_norm_shift``, L2
``sgu_mix_gate`` vs ``fused_sgu_mix_gate``, each in float32 and bfloat16.
Tolerances: float32 to 1e-5 (summation order); bfloat16 to 2^-7
relative plus 2^-7 absolute (two bfloat16 ulps of values near 1: each
side rounds once from float32 sums taken in different orders). The
CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.ops.pallas_attention import pallas_local_attention
from progen_tpu.ops.pallas_layers import fused_norm_shift, fused_sgu_mix_gate
from progen_tpu_torch.ops import cuda_attention, cuda_layers
from progen_tpu_torch.ops.dispatch import check_same_device, takes_kernel

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -7, rtol=2 ** -7)}
EPS = 1e-5


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


def _close(j, t, dtype):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j.astype(jnp.float32)), **TOL[dtype])


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """On the CPU no wrapper launches a kernel, so no count moves."""
    before = (cuda_attention.local_attention_fwd.launches,
              cuda_layers.norm_shift.launches,
              cuda_layers.sgu_mix_gate.launches)
    yield
    assert (cuda_attention.local_attention_fwd.launches,
            cuda_layers.norm_shift.launches,
            cuda_layers.sgu_mix_gate.launches) == before


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
        """The kernel keeps P in float32 for P·V; the plain attention op
        rounds P to bfloat16 first. The two differ in bfloat16."""
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
        assert _build.KERNELS == ("local_attention_fwd", "norm_shift",
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
