"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
built from progen_tpu_torch/csrc at first use); on a host without one
they skip. Run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The file imports torch only, and ``--noconftest`` skips the suite's
conftest (which sets JAX up), so it runs where JAX is not installed.
Tolerances: float32 to 1e-5 absolute plus 1e-5 relative (summation
order); bfloat16 and float16 to 1e-2 absolute plus 1e-2 relative (about
one ulp of values near 1: the kernel and the plain version each round
once from float32 values summed in different orders), 2e-2 for the SGU
tail, whose product x * gate rounds twice.
"""

import pytest
import torch

from progen_tpu_torch.models import layers
from progen_tpu_torch.ops import cuda_attention, cuda_layers

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2),
       torch.float16: (1e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _check(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,h,n,d,w", [
    (2, 3, 64, 16, 16), (1, 2, 96, 32, 32), (2, 2, 512, 64, 128),
    (1, 2, 256, 128, 64), (1, 4, 1024, 64, 512), (1, 1, 300, 64, 100),
])
def test_local_attention_fwd(dev, dtype, b, h, n, d, w):
    gen = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
               for _ in range(3))
    before = cuda_attention.local_attention_fwd.launches
    got = cuda_attention.local_attention_fwd(q, k, v, w)
    assert cuda_attention.local_attention_fwd.launches == before + 1
    want = cuda_attention.local_attention_fwd_reference(q, k, v, w)
    _check(got, want, *TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(2, 32, 33), (2, 64, 512),
                                   (8, 1024, 1024), (1, 16, 1792),
                                   (1, 8, 2048)])
def test_norm_shift(dev, dtype, b, n, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _randn(gen, b, n, d, dtype=dtype, dev=dev) * 3 + 1
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    got = cuda_layers.norm_shift(x, scale, 1e-5, dtype)
    want = cuda_layers.norm_shift_reference(x, scale, 1e-5, dtype)
    _check(got, want, *TOL[dtype])
    assert torch.all(got[:, 0, :d - d // 2] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d", [(2, 32, 24), (1, 100, 70),
                                   (2, 256, 128), (2, 1024, 2048)])
def test_sgu_mix_gate(dev, dtype, b, n, d):
    gen = torch.Generator(device=dev).manual_seed(n)
    x, gate = (_randn(gen, b, n, d, dtype=dtype, dev=dev) for _ in range(2))
    w = _randn(gen, n, n, dtype=torch.float32, dev=dev) / n ** 0.5
    bias = _randn(gen, n, 1, dtype=torch.float32, dev=dev)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    got = cuda_layers.sgu_mix_gate(x, gate, w, bias, scale, 1e-5, dtype)
    want = cuda_layers.sgu_mix_gate_reference(x, gate, w, bias, scale, 1e-5,
                                              dtype)
    atol, rtol = TOL[dtype]
    _check(got, want, 2 * atol if dtype != torch.float32 else atol,
           2 * rtol if dtype != torch.float32 else rtol)


def test_model_forward_goes_through_kernels(dev, monkeypatch):
    from progen_tpu_torch import ProGen, ProGenConfig

    cfg = ProGenConfig(num_tokens=32, dim=64, seq_len=64, depth=3,
                       window_size=16, global_mlp_depth=1, heads=2,
                       dim_head=16, ff_mult=2)
    model = ProGen(cfg, device="cuda", seed=0)
    toks = torch.randint(0, 32, (2, 64), device=dev)
    counts = (cuda_attention.local_attention_fwd.launches,
              cuda_layers.norm_shift.launches,
              cuda_layers.sgu_mix_gate.launches)
    with torch.inference_mode():
        got = model(toks)
    assert (cuda_attention.local_attention_fwd.launches - counts[0],
            cuda_layers.norm_shift.launches - counts[1],
            cuda_layers.sgu_mix_gate.launches - counts[2]) == (3, 6, 1)
    # the same model with each kernel's plain version in its place
    monkeypatch.setattr(layers, "local_attention_fwd",
                        cuda_attention.local_attention_fwd_reference)
    monkeypatch.setattr(layers, "norm_shift",
                        cuda_layers.norm_shift_reference)
    monkeypatch.setattr(layers, "sgu_mix_gate",
                        cuda_layers.sgu_mix_gate_reference)
    with torch.inference_mode():
        want = model(toks)
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)


def test_bad_inputs_raise(dev):
    q = torch.zeros(1, 1, 64, 48, device=dev)
    with pytest.raises(ValueError):
        cuda_attention.local_attention_fwd(q, q, q, 16)  # dim_head 48
    x = torch.zeros(1, 8, 4096, device=dev)
    with pytest.raises(ValueError):
        cuda_layers.norm_shift(x, torch.ones(4096, device=dev), 1e-5,
                               torch.float32)
    x = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(ValueError, match="several devices"):
        cuda_layers.norm_shift(x, torch.ones(64), 1e-5, torch.float32)
    with pytest.raises(ValueError, match="scale"):
        cuda_layers.norm_shift(x, torch.ones(32, device=dev), 1e-5,
                               torch.float32)
