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
tail, whose product x * gate rounds twice. The attention backward in
float32 to 1e-4 absolute plus 1e-4 relative: each gradient is a second
float32 sum, over up to 2w rows or keys, of terms that themselves come
from the softmax statistics, both taken in another order than the plain
version takes them. In bfloat16 and float16 the forward and backward
kernels run on the tensor cores: the backwards round P and dS to the
input dtype before the products that take them, the forward carries P
into P·V as two input-dtype parts; the plain version keeps them in
float32, and the same 1e-2 tolerance holds. The SGU tail in bfloat16
runs its mix on the tensor cores with the float32 weights split into two
bfloat16 parts (16 of their 24 bits); in float16 and float32 on the FMA
units.
"""

import pytest
import torch

from progen_tpu_torch.models import layers
from progen_tpu_torch.ops import cuda_attention, cuda_layers
from torch_sgu_split import bf16_ulp, split_mix

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2),
       torch.float16: (1e-2, 1e-2)}
BWD_TOL = {**TOL, torch.float32: (1e-4, 1e-4)}
SHAPES = [  # (b, h, n, d, w)
    (2, 3, 64, 16, 16), (1, 2, 96, 32, 32), (2, 2, 512, 64, 128),
    (1, 2, 256, 128, 64), (1, 4, 1024, 64, 512), (1, 1, 300, 64, 100),
    (1, 2, 128, 64, 128), (1, 2, 512, 128, 256),
]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
SMALL = dict(num_tokens=32, dim=64, seq_len=64, depth=3, window_size=16,
             global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)


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
@pytest.mark.parametrize("b,h,n,d,w", SHAPES)
def test_local_attention_fwd(dev, dtype, b, h, n, d, w):
    gen = torch.Generator(device=dev).manual_seed(n + d)
    q, k, v = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
               for _ in range(3))
    before = cuda_attention.local_attention_fwd.launches
    got = cuda_attention.local_attention_fwd(q, k, v, w)
    assert cuda_attention.local_attention_fwd.launches == before + 1
    want = cuda_attention.local_attention_fwd_reference(q, k, v, w)
    _check(got, want, *TOL[dtype])


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attention_fwd_is_deterministic(dev, dtype, halo):
    """A1 and A4's forward launched twice on the same inputs give
    bit-equal outputs (the shard identity needs them so)."""
    b, h, n, d, w = 2, 2, 512, 64, 128
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
               for _ in range(3))
    if halo:
        hk, hv = (_randn(gen, b, h, w, d, dtype=dtype, dev=dev)
                  for _ in range(2))
        runs = [cuda_attention.local_attention_halo_fwd(q, k, v, hk, hv, w)
                for _ in range(2)]
    else:
        runs = [cuda_attention.local_attention_fwd(q, k, v, w)
                for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_local_attention_fwd_takes_tensor_cores(dev, dtype):
    """A bfloat16 or float16 call launches the tensor-core kernel, which
    sums in another order than the FMA kernel and carries P into P·V as
    two input-dtype parts: counted once, its output differs from the
    float32 FMA kernel's on the same values (which it would equal, rounded,
    if the call took the FMA kernel) and stays within the tolerance of
    it."""
    b, h, n, d, w = 2, 4, 1024, 64, 512
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
               for _ in range(3))
    fn = cuda_attention.local_attention_fwd
    before = fn.launches
    got = fn(q, k, v, w)
    assert fn.launches == before + 1
    fma = fn(q.float(), k.float(), v.float(), w).to(dtype)
    torch.cuda.synchronize()
    assert not torch.equal(got, fma)
    _check(got, fma, *TOL[dtype])


@pytest.mark.parametrize("impl", ["kv", "halo"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,w", SHAPES)
def test_local_attention_bwd(dev, impl, dtype, b, h, n, d, w):
    gen = torch.Generator(device=dev).manual_seed(n + d + 1)
    q, k, v, do = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    fn = getattr(cuda_attention, f"local_attention_bwd_{impl}")
    ref = getattr(cuda_attention, f"local_attention_bwd_{impl}_reference")
    before = fn.launches
    got = fn(q, k, v, do, w)
    assert fn.launches == before + 1
    want = ref(q, k, v, do, w)
    for g, r in zip(got, want):
        _check(g, r, *BWD_TOL[dtype])


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("impl", ["kv", "halo"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_attention_bwd_is_deterministic(dev, impl, dtype, halo):
    """A2 and A3 (and their A4 forms) launched twice on the same inputs
    give bit-equal dq, dk and dv: no atomics, no order that changes from
    run to run (the shard identity needs dq so)."""
    b, h, n, d, w = 2, 2, 512, 64, 128
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    if halo:
        hk, hv = (_randn(gen, b, h, w, d, dtype=dtype, dev=dev)
                  for _ in range(2))
        fn = getattr(cuda_attention, f"local_attention_halo_bwd_{impl}")
        runs = [fn(q, k, v, hk, hv, do, w) for _ in range(2)]
    else:
        fn = getattr(cuda_attention, f"local_attention_bwd_{impl}")
        runs = [fn(q, k, v, do, w) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.parametrize("impl", ["kv", "halo"])
def test_local_attention_carries_grad_fn(dev, impl):
    """The regression test of the repaired fault: on a CUDA tensor that
    requires grad, the kernel's output carries a grad_fn whose backward is
    A2 or A3, and the gradients are those of the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (_randn(gen, 2, 2, 64, 16, dtype=torch.float32, dev=dev)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bwd = getattr(cuda_attention, f"local_attention_bwd_{impl}")
    before = bwd.launches
    out = cuda_attention.local_attention(*leaves, 16, bwd_impl=impl)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert bwd.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        cuda_attention.local_attention_fwd_reference(*plain, 16), plain, do)
    for g, r in zip(got, want):
        _check(g, r, *BWD_TOL[torch.float32])


def test_layers_carry_grad_fn(dev):
    """norm_shift and sgu_mix_gate are differentiable on the card; their
    backward is the autograd of the plain composition."""
    gen = torch.Generator(device=dev).manual_seed(8)
    x = _randn(gen, 2, 32, 48, dtype=torch.float32, dev=dev) * 2 + 0.5
    scale = torch.rand(48, generator=gen, device=dev) + 0.5
    g = _randn(gen, 2, 32, 48, dtype=torch.float32, dev=dev)
    pairs = [
        (cuda_layers.norm_shift, cuda_layers.norm_shift_reference,
         (x, scale), (1e-5, torch.float32)),
    ]
    xs, gate = (_randn(gen, 2, 32, 24, dtype=torch.float32, dev=dev)
                for _ in range(2))
    w = _randn(gen, 32, 32, dtype=torch.float32, dev=dev) / 32 ** 0.5
    bias = _randn(gen, 32, 1, dtype=torch.float32, dev=dev)
    s2 = torch.rand(24, generator=gen, device=dev) + 0.5
    pairs.append((cuda_layers.sgu_mix_gate,
                  cuda_layers.sgu_mix_gate_reference,
                  (xs, gate, w, bias, s2), (1e-5, torch.float32)))
    for fn, ref, tensors, args in pairs:
        a = [t.clone().requires_grad_(True) for t in tensors]
        out = fn(*a, *args)
        assert out.grad_fn is not None
        cot = g if out.shape == g.shape else torch.ones_like(out)
        got = torch.autograd.grad(out, a, cot)
        r = [t.clone().requires_grad_(True) for t in tensors]
        want = torch.autograd.grad(ref(*r, *args), r, cot)
        for gg, ww in zip(got, want):
            _check(gg, ww, *BWD_TOL[torch.float32])


NORM_SHIFT_SHAPES = [(2, 32, 33), (2, 64, 512), (8, 1024, 1024),
                     (1, 16, 1792), (1, 8, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", NORM_SHIFT_SHAPES)
def test_norm_shift(dev, dtype, b, n, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _randn(gen, b, n, d, dtype=dtype, dev=dev) * 3 + 1
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    got = cuda_layers.norm_shift(x, scale, 1e-5, dtype)
    want = cuda_layers.norm_shift_reference(x, scale, 1e-5, dtype)
    _check(got, want, *TOL[dtype])
    assert torch.all(got[:, 0, :d - d // 2] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", NORM_SHIFT_SHAPES + [(2, 16, 24)])
def test_norm_shift_with_prev(dev, dtype, b, n, d):
    """L1 with a previous row for row 0 of every sequence, at the widths
    of the shipped configs (512, 1024, 1792, 2048: 16-byte vectors) and
    at widths that take one element a lane (33) or whose split cuts a
    vector (24: split 12)."""
    gen = torch.Generator(device=dev).manual_seed(d + 1)
    x = _randn(gen, b, n, d, dtype=dtype, dev=dev) * 3 + 1
    prev = _randn(gen, b, 1, d, dtype=dtype, dev=dev) * 3 + 1
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    before = cuda_layers.norm_shift.launches
    got = cuda_layers.norm_shift(x, scale, 1e-5, dtype, prev)
    assert cuda_layers.norm_shift.launches == before + 1
    want = cuda_layers.norm_shift_reference(x, scale, 1e-5, dtype, prev)
    _check(got, want, *TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_shift_takes_any_alignment(dev, dtype):
    """A view at an odd offset (rows off the 16-byte grid) is realigned
    by the wrapper: its output is its aligned copy's, bit for bit, and
    agrees with the plain version."""
    gen = torch.Generator(device=dev).manual_seed(9)
    b, n, d = 2, 64, 512
    flat = _randn(gen, b * n * d + 1, dtype=dtype, dev=dev) * 3 + 1
    x = flat[1:].view(b, n, d)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    got = cuda_layers.norm_shift(x, scale, 1e-5, dtype)
    aligned = cuda_layers.norm_shift(x.clone(), scale, 1e-5, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    _check(got, cuda_layers.norm_shift_reference(x, scale, 1e-5, dtype),
           *TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,d", [(2, 32, 24), (1, 100, 70),
                                   (2, 256, 128), (2, 1024, 2048),
                                   (1, 33, 16), (8, 1024, 2048)])
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


def _kernel_names(fn) -> set:
    """The names of the CUDA kernels that ``fn()`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgu_mix_gate_takes_tensor_cores_in_bfloat16(dev, dtype):
    """A bfloat16 call launches the gate pass and the tensor-core mix
    (sgu_gate_norm, sgu_mix_tc_kernel); float16 and float32 the FMA
    kernel (sgu_gate_stats, sgu_mix_kernel). Each call counts once."""
    b, n, d = 2, 256, 128
    gen = torch.Generator(device=dev).manual_seed(12)
    x, gate = (_randn(gen, b, n, d, dtype=dtype, dev=dev) for _ in range(2))
    w = _randn(gen, n, n, dtype=torch.float32, dev=dev) / n ** 0.5
    bias = _randn(gen, n, 1, dtype=torch.float32, dev=dev)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    fn = cuda_layers.sgu_mix_gate
    fn(x, gate, w, bias, scale, 1e-5, dtype)  # built and loaded
    before = fn.launches
    names = " ".join(_kernel_names(
        lambda: fn(x, gate, w, bias, scale, 1e-5, dtype)))
    assert fn.launches == before + 1
    tc = dtype == torch.bfloat16
    assert ("sgu_mix_tc_kernel" in names) == tc, names
    assert ("sgu_gate_norm" in names) == tc, names
    assert ("sgu_mix_kernel" in names) == (not tc), names


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgu_mix_gate_is_deterministic(dev, dtype):
    """L2 launched twice on the same inputs gives bit-equal outputs (the
    shard identity needs them so)."""
    b, n, d = 2, 1024, 512
    gen = torch.Generator(device=dev).manual_seed(13)
    x, gate = (_randn(gen, b, n, d, dtype=dtype, dev=dev) for _ in range(2))
    w = _randn(gen, n, n, dtype=torch.float32, dev=dev) / n ** 0.5
    bias = _randn(gen, n, 1, dtype=torch.float32, dev=dev)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    runs = [cuda_layers.sgu_mix_gate(x, gate, w, bias, scale, 1e-5, dtype)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)



def test_sgu_mix_tc_carries_w_lo(dev):
    """The bfloat16 mix adds W_lo g as well as W_hi g. With x = 1, no
    bias, scale 1 and each gate row half +1 and half -1 (mean 0 and
    variance 1 in any order of summation, so the kernel's gate pass and
    the plain norm give the same g = +-1), the output is bf16(mix). The
    kernel is held elementwise within one bfloat16 ulp (plus 2^-16 for
    outputs near zero, where the float32 sums' order shows) of the split
    mix written out on the CPU (tests/torch_sgu_split.py), and its mean
    distance from the exact mix, in ulps, is under a quarter of that of
    the mix of bf16(W) alone (about 0.25 against 2.8 written out: a mix
    of 1024 terms loses to W's rounding what its cancellation wins)."""
    b, n, d = 2, 1024, 256
    gen = torch.Generator().manual_seed(14)
    signs = torch.tensor([1.0, -1.0]).repeat_interleave(d // 2)
    gate = torch.stack([signs[torch.randperm(d, generator=gen)]
                        for _ in range(b * n)]).reshape(b, n, d).bfloat16()
    x = torch.ones(b, n, d, dtype=torch.bfloat16)
    w = torch.randn(n, n, generator=gen) / n ** 0.5
    bias, scale = torch.zeros(n, 1), torch.ones(d)
    args = (x, gate, w, bias, scale)
    got = cuda_layers.sgu_mix_gate(*(t.to(dev) for t in args), 1e-5,
                                   torch.bfloat16).cpu().float()
    split, _ = split_mix(*args, 1e-5)
    once, _ = split_mix(*args, 1e-5, split=False)
    split, once = split.float(), once.float()
    over = (got - split).abs() - bf16_ulp(split) - 2.0 ** -16
    assert not bool((over > 0).any()), (int((over > 0).sum()),
                                        float(over.max()))
    g = cuda_layers.norm_reference(gate, scale, 1e-5, torch.bfloat16)
    exact = torch.tril(w).double() @ g.double()

    def dist(t):
        return float(((t - exact).abs() / bf16_ulp(exact)).mean())

    assert dist(got) * 4 < dist(once), (dist(got), dist(once))


def test_sampling_noise_is_the_cpus(dev):
    """Draw t of a row is bit-equal on the CPU and on the card: the noise
    is drawn by a CPU generator and copied to the logits' device."""
    from progen_tpu_torch import sampling

    seeds = [sampling.row_seed(7, i) for i in range(3)]
    draw = sampling._seeded_draws(seeds)
    for t in (0, 1, 100):
        card = draw(t, torch.zeros(3, 256, device=dev))
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), draw(t, torch.zeros(3, 256)))


@pytest.mark.parametrize("impl", ["kv", "halo"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,n,d,w", SHAPES)
def test_local_attention_halo(dev, impl, dtype, b, h, n, d, w):
    """A4: the forward and both backwards with a halo against their plain
    versions, each launch counted under A4's own names."""
    gen = torch.Generator(device=dev).manual_seed(n + d + 2)
    q, k, v, do = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    hk, hv = (_randn(gen, b, h, w, d, dtype=dtype, dev=dev)
              for _ in range(2))
    fwd = cuda_attention.local_attention_halo_fwd
    before = (fwd.launches, cuda_attention.local_attention_fwd.launches)
    got = fwd(q, k, v, hk, hv, w)
    assert (fwd.launches, cuda_attention.local_attention_fwd.launches) == \
        (before[0] + 1, before[1])
    _check(got, cuda_attention.local_attention_halo_fwd_reference(
        q, k, v, hk, hv, w), *TOL[dtype])
    fn = getattr(cuda_attention, f"local_attention_halo_bwd_{impl}")
    ref = getattr(cuda_attention,
                  f"local_attention_halo_bwd_{impl}_reference")
    before = fn.launches
    got = fn(q, k, v, hk, hv, do, w)
    assert fn.launches == before + 1
    for g, r in zip(got, ref(q, k, v, hk, hv, do, w)):
        _check(g, r, *BWD_TOL[dtype])


@pytest.mark.parametrize("impl", ["kv", "halo"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_shard_identity(dev, impl, dtype):
    """Two shards through A4, each with its halo sliced from the other,
    concatenated, equal A1 and A2/A3 on the whole sequence: the output and
    dq bit for bit (one kernel over the same keys in the same order); dk
    and dv once shard 1's halo gradient (halo_grads) is added to shard
    0's last window, to the backward tolerance (two roundings there where
    the whole sequence has one)."""
    b, h, n, d, w = 2, 2, 512, 64, 128
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (_randn(gen, b, h, n, d, dtype=dtype, dev=dev)
                   for _ in range(4))
    bwd_whole = getattr(cuda_attention, f"local_attention_bwd_{impl}")
    bwd_shard = getattr(cuda_attention, f"local_attention_halo_bwd_{impl}")
    whole = cuda_attention.local_attention_fwd(q, k, v, w)
    gwhole = bwd_whole(q, k, v, do, w)
    m = n // 2
    s0, s1 = (slice(0, m), slice(m, n))
    zeros = torch.zeros(b, h, w, d, dtype=dtype, device=dev)
    halos = [(zeros, zeros), (k[:, :, m - w:m], v[:, :, m - w:m])]
    outs, grads = [], []
    for sl, (hk, hv) in zip((s0, s1), halos):
        args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], hk, hv)
        outs.append(cuda_attention.local_attention_halo_fwd(*args, w))
        grads.append(list(bwd_shard(*args, do[:, :, sl], w)))
    dhk, dhv = cuda_attention.halo_grads(q[:, :, s1], k[:, :, s1],
                                         v[:, :, s1], *halos[1],
                                         do[:, :, s1], w)
    grads[0][1][:, :, -w:] += dhk
    grads[0][2][:, :, -w:] += dhv
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 2), whole)
    got = [torch.cat(pair, 2) for pair in zip(*grads)]
    assert torch.equal(got[0], gwhole[0])
    for g, r in zip(got[1:], gwhole[1:]):
        _check(g, r, *BWD_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_shift_prev_row(dev, dtype):
    """L1 over two shards, the second with the first's last row as its
    previous row, equals L1 over the whole sequence bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(4)
    x = _randn(gen, 2, 64, 512, dtype=dtype, dev=dev) * 3 + 1
    scale = torch.rand(512, generator=gen, device=dev) + 0.5
    whole = cuda_layers.norm_shift(x, scale, 1e-5, dtype)
    first = cuda_layers.norm_shift(x[:, :32], scale, 1e-5, dtype)
    second = cuda_layers.norm_shift(x[:, 32:], scale, 1e-5, dtype,
                                    x[:, 31:32])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat((first, second), 1), whole)
    _check(second, cuda_layers.norm_shift_reference(
        x[:, 32:], scale, 1e-5, dtype, x[:, 31:32]), *TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("row0,rows", [(0, 256), (256, 256), (100, 60),
                                       (5, 300)])
def test_sgu_mix_gate_rows(dev, dtype, row0, rows):
    """L2's rows [row0, row0 + rows) against the whole gate equal those
    rows of the whole mix bit for bit, and the plain version."""
    b, n, d = 2, 512, 128
    gen = torch.Generator(device=dev).manual_seed(row0 + rows)
    x, gate = (_randn(gen, b, n, d, dtype=dtype, dev=dev) for _ in range(2))
    w = _randn(gen, n, n, dtype=torch.float32, dev=dev) / n ** 0.5
    bias = _randn(gen, n, 1, dtype=torch.float32, dev=dev)
    scale = torch.rand(d, generator=gen, device=dev) + 0.5
    sl = slice(row0, row0 + rows)
    whole = cuda_layers.sgu_mix_gate(x, gate, w, bias, scale, 1e-5, dtype)
    args = (x[:, sl], gate, w[sl], bias[sl], scale, 1e-5, dtype, row0)
    got = cuda_layers.sgu_mix_gate(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, whole[:, sl])
    atol, rtol = TOL[dtype]
    _check(got, cuda_layers.sgu_mix_gate_reference(*args),
           2 * atol if dtype != torch.float32 else atol,
           2 * rtol if dtype != torch.float32 else rtol)


def _rank_forward(rank, port, out_dir):
    """One of two ranks sharing card 0 over gloo: the sequence-sharded
    forward and backward of a small model; saves what the test checks."""
    import os

    from progen_tpu_torch import ProGen, ProGenConfig
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.parallel.collectives import all_reduce_

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE="2")
    torch.cuda.set_device(0)
    grid = init_grid(1, 2, "gloo", timeout=120)
    model = ProGen(ProGenConfig(**SMALL), device="cuda", seed=0)
    toks = torch.arange(2 * 64, device="cuda").reshape(2, 64) % 31 + 1
    out = model(toks[:, grid.seq_slice(64)], grid)
    has_grad_fn = out.grad_fn is not None
    out.logsumexp(-1).sum().backward()
    grads = [p.grad for p in model.parameters()]
    all_reduce_(grads, grid.world_group)
    torch.save({"logits": out.detach().cpu(), "grad_fn": has_grad_fn,
                "grads": [g.cpu() for g in grads]},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_two_ranks_share_the_card_over_gloo(dev, tmp_path):
    """Two gloo ranks on one card run the sequence-sharded model (A4, L1
    with the halo row, L2 over the gathered gate): every output carries a
    grad_fn, and the logits and the summed gradients agree with one
    process on the whole sequence (bfloat16: logits to 0.1, gradients to
    5e-2 of each tensor's largest)."""
    import socket

    import torch.multiprocessing as mp

    from progen_tpu_torch import ProGen, ProGenConfig
    from progen_tpu_torch.ops import _build

    _build.build_all()  # once, here, not in both ranks at once
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_forward, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert all(r["grad_fn"] for r in res)
    model = ProGen(ProGenConfig(**SMALL), device="cuda", seed=0)
    toks = torch.arange(2 * 64, device=dev).reshape(2, 64) % 31 + 1
    want = model(toks)
    want.logsumexp(-1).sum().backward()
    got = torch.cat([r["logits"] for r in res], 1)
    torch.testing.assert_close(got, want.detach().cpu(), atol=0.1, rtol=0)
    for g, p in zip(res[0]["grads"], model.parameters()):
        scale = p.grad.abs().max().item()
        torch.testing.assert_close(g, p.grad.cpu(), atol=5e-2 * scale,
                                   rtol=0)


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
    monkeypatch.setattr(layers, "local_attention", _plain_attention)
    monkeypatch.setattr(layers, "norm_shift",
                        cuda_layers.norm_shift_reference)
    monkeypatch.setattr(layers, "sgu_mix_gate",
                        cuda_layers.sgu_mix_gate_reference)
    with torch.inference_mode():
        want = model(toks)
    torch.testing.assert_close(got, want, atol=0.1, rtol=0)


def _plain_attention(q, k, v, window_size, scale=None, bwd_impl="kv"):
    return cuda_attention.local_attention_fwd_reference(q, k, v,
                                                        window_size, scale)


@pytest.mark.parametrize("remat", [False, True])
def test_model_backward_goes_through_kernels(dev, monkeypatch, remat):
    """One ProGen backward on the card launches A2 once per layer, gives a
    non-zero gradient on every parameter, and agrees with the same
    model's gradients on the plain path (float32, to 1e-3 of each
    tensor's largest gradient: three layers of float32 sums in another
    order)."""
    from progen_tpu_torch import ProGen, ProGenConfig

    cfg = ProGenConfig(dtype="float32", remat=remat, **SMALL)
    model = ProGen(cfg, device="cuda", seed=0)
    toks = torch.randint(0, 32, (2, 64), device=dev)

    def grads():
        model.zero_grad(set_to_none=True)
        model(toks).logsumexp(-1).mean().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    bwd = cuda_attention.local_attention_bwd_kv
    fwd = cuda_attention.local_attention_fwd
    before = (bwd.launches, fwd.launches)
    got = grads()
    assert bwd.launches - before[0] == cfg.depth
    assert fwd.launches - before[1] == cfg.depth * (2 if remat else 1)
    for name, g in got.items():
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0), \
            name
    monkeypatch.setattr(layers, "local_attention", _plain_attention)
    monkeypatch.setattr(layers, "norm_shift",
                        cuda_layers.norm_shift_reference)
    monkeypatch.setattr(layers, "sgu_mix_gate",
                        cuda_layers.sgu_mix_gate_reference)
    want = grads()
    for name in got:
        scale = want[name].abs().max().item()
        torch.testing.assert_close(got[name], want[name],
                                   atol=1e-3 * scale + 1e-7, rtol=0,
                                   msg=name)


def test_bad_inputs_raise(dev):
    q = torch.zeros(1, 1, 64, 48, device=dev)
    with pytest.raises(ValueError):
        cuda_attention.local_attention_fwd(q, q, q, 16)  # dim_head 48
    with pytest.raises(ValueError):
        cuda_attention.local_attention_bwd_kv(q, q, q, q, 16)
    with pytest.raises(ValueError):
        cuda_attention.local_attention_bwd_halo(q, q, q, q, 16)
    with pytest.raises(ValueError, match="bwd_impl"):
        cuda_attention.local_attention(q, q, q, 16, bwd_impl="kv_g2")
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
