"""Kernel A4's plain version against the TPU kernel it replaces, and the
shard boundary of A4, L1 and L2, on the CPU.

* A4: ``local_attention`` with ``halo_k``/``halo_v`` (forward
  ``local_attention_halo_fwd``, backward ``local_attention_halo_bwd_kv`` or
  ``..._halo`` plus ``halo_grads``) against ``pallas_local_attention_halo``
  in Pallas interpret mode: the output and all five gradients (through
  ``jax.vjp``), for both backwards, with zero and random halos.
  Tolerances as ``tests/test_torch_kernels.py`` holds A1–A3: float32 to
  1e-5, bfloat16 to 2^-7 absolute plus 2^-7 relative.
* The shard identity: a sequence cut into shards, each with its left
  neighbour's last window as its halo, through A4's plain versions; the
  shards concatenated equal A1/A2/A3's plain versions on the whole
  sequence, dk and dv once each shard's halo gradient is added to its
  neighbour's last window (float32, to 1e-5: the same sums, cut in two).
* L1 over shards with the neighbour's last row as ``prev``, and L2's
  rows at an offset against the whole gate, equal the whole-sequence
  layer sliced, forward and gradients (float32 to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.ops.pallas_attention import pallas_local_attention_halo
from progen_tpu_torch.ops import cuda_attention, cuda_layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -7, rtol=2 ** -7)}
F32 = dict(atol=1e-5, rtol=1e-5)
A4_WRAPPERS = ("local_attention_halo_fwd", "local_attention_halo_bwd_kv",
               "local_attention_halo_bwd_halo")


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jnp.float32).astype(jd), torch.from_numpy(a).to(td)


@pytest.fixture(autouse=True)
def _counts_stay_zero():
    """On the CPU no wrapper launches a kernel, so no count moves."""
    before = [getattr(cuda_attention, n).launches for n in A4_WRAPPERS]
    yield
    assert [getattr(cuda_attention, n).launches
            for n in A4_WRAPPERS] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("halo", ["zero", "random"])
@pytest.mark.parametrize("impl", ["kv", "halo"])
def test_a4_matches_pallas_halo(impl, halo, dtype):
    b, h, n, d, w = 2, 2, 32, 16, 8
    rng = np.random.default_rng(30)
    q, k, v, do = (rng.standard_normal((b, h, n, d), np.float32)
                   for _ in range(4))
    hk, hv = (rng.standard_normal((b, h, w, d), np.float32)
              if halo == "random" else np.zeros((b, h, w, d), np.float32)
              for _ in range(2))
    pairs = [_pair(a, dtype) for a in (q, k, v, hk, hv, do)]
    jargs = [j for j, _ in pairs[:5]]
    jout, vjp = jax.vjp(
        lambda *a: pallas_local_attention_halo(*a, w, None, True, impl, 1,
                                               "pallas"), *jargs)
    jgrads = vjp(pairs[5][0])
    leaves = [t.clone().requires_grad_(True) for _, t in pairs[:5]]
    out = cuda_attention.local_attention(
        *leaves[:3], w, bwd_impl=impl, halo_k=leaves[3], halo_v=leaves[4])
    grads = torch.autograd.grad(out, leaves, pairs[5][1])
    assert out.dtype == leaves[0].dtype
    for name, j, t in zip(("out", "dq", "dk", "dv", "dhalo_k", "dhalo_v"),
                          (jout, *jgrads), (out, *grads)):
        np.testing.assert_allclose(
            t.detach().float().numpy(), np.asarray(j.astype(jnp.float32)),
            err_msg=name, **TOL[dtype])


def test_zero_halo_equals_the_phantom_keys():
    """Shard 0's halo is zeros, which the reference's window 0 sees as its
    phantom keys: A4 with a zero halo is A1/A2."""
    rng = np.random.default_rng(31)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 32, 16),
                                                        np.float32))
                   for _ in range(4))
    z = torch.zeros(1, 2, 8, 16)
    torch.testing.assert_close(
        cuda_attention.local_attention_halo_fwd(q, k, v, z, z, 8),
        cuda_attention.local_attention_fwd(q, k, v, 8), **F32)
    for a, b in zip(
            cuda_attention.local_attention_halo_bwd_kv(q, k, v, z, z, do, 8),
            cuda_attention.local_attention_bwd_kv(q, k, v, do, 8)):
        torch.testing.assert_close(a, b, **F32)


@pytest.mark.parametrize("impl", ["kv", "halo"])
@pytest.mark.parametrize("shards", [2, 4])
def test_shard_identity(impl, shards):
    b, h, n, d, w = 2, 2, 64, 16, 8
    rng = np.random.default_rng(32)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, h, n, d),
                                                        np.float32))
                   for _ in range(4))
    whole = cuda_attention.local_attention_fwd(q, k, v, w)
    gwhole = getattr(cuda_attention, f"local_attention_bwd_{impl}")(
        q, k, v, do, w)
    bwd = getattr(cuda_attention, f"local_attention_halo_bwd_{impl}")
    m, zeros = n // shards, torch.zeros(b, h, w, d)
    outs, grads, halo_grads = [], [], []
    for s in range(shards):
        sl = slice(s * m, (s + 1) * m)
        hk, hv = ((zeros, zeros) if s == 0 else
                  (k[:, :, s * m - w:s * m], v[:, :, s * m - w:s * m]))
        args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], hk, hv)
        outs.append(cuda_attention.local_attention_halo_fwd(*args, w))
        grads.append(list(bwd(*args, do[:, :, sl], w)))
        halo_grads.append(cuda_attention.halo_grads(*args, do[:, :, sl], w))
    for s in range(shards - 1):  # shard s + 1's halo is shard s's end
        grads[s][1][:, :, -w:] += halo_grads[s + 1][0]
        grads[s][2][:, :, -w:] += halo_grads[s + 1][1]
    torch.testing.assert_close(torch.cat(outs, 2), whole, **F32)
    for got, want in zip(zip(*grads), gwhole):
        torch.testing.assert_close(torch.cat(got, 2), want, **F32)


@pytest.mark.parametrize("shards", [2, 4])
def test_norm_shift_with_prev_row_matches_whole(shards):
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((2, 32, 24), np.float32) * 2
                         + 0.5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 24).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 32, 24), np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, scale)]
    whole = cuda_layers.norm_shift(*leaves, 1e-5, torch.float32)
    want = torch.autograd.grad(whole, leaves, g)
    xs = leaves[0].detach().requires_grad_(True)
    sc = scale.clone().requires_grad_(True)
    m, parts = 32 // shards, []
    for s in range(shards):
        prev = None if s == 0 else xs[:, s * m - 1:s * m]
        parts.append(cuda_layers.norm_shift(xs[:, s * m:(s + 1) * m], sc,
                                            1e-5, torch.float32, prev))
    got = torch.cat(parts, 1)
    torch.testing.assert_close(got, whole.detach(), **F32)
    for a, b in zip(torch.autograd.grad(got, (xs, sc), g), want):
        torch.testing.assert_close(a, b, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sgu_rows_match_whole_sliced(shards, dtype):
    """L2's plain version at a row offset (the shard's rows of x, the
    weights and the biases, the whole gate) against the whole layer
    sliced; in float32 its gradients too, summed over the shards."""
    td = DTYPES[dtype][1]
    b, n, d = 2, 32, 12
    rng = np.random.default_rng(34)
    x, gate, g = (torch.from_numpy(rng.standard_normal((b, n, d),
                                                       np.float32))
                  for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((n, n), np.float32)
                         / np.sqrt(n))
    bias = torch.from_numpy(rng.standard_normal((n, 1), np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    leaves = [t.clone().requires_grad_(True)
              for t in (x.to(td), gate.to(td), w, bias, scale)]
    whole = cuda_layers.sgu_mix_gate(*leaves, 1e-5, td)
    want = torch.autograd.grad(whole, leaves, g.to(td))
    shard_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    xs, gs, ws, bs, ss = shard_leaves
    m, parts = n // shards, []
    for s in range(shards):
        sl = slice(s * m, (s + 1) * m)
        parts.append(cuda_layers.sgu_mix_gate(
            xs[:, sl], gs, ws[sl], bs[sl], ss, 1e-5, td, s * m))
    got = torch.cat(parts, 1)
    torch.testing.assert_close(got.float(), whole.detach().float(),
                               **TOL[dtype])
    if dtype == "float32":
        for a, c in zip(torch.autograd.grad(got, shard_leaves, g), want):
            torch.testing.assert_close(a, c, **F32)


def test_sgu_rows_out_of_range_raise():
    x = torch.zeros(1, 8, 4)
    gate = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="rows"):
        cuda_layers._sgu_mix_gate_kernel(
            x, gate, torch.zeros(8, 16), torch.zeros(8, 1), torch.ones(4),
            1e-5, torch.float32, 12)


def test_halo_operands_are_checked():
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="both"):
        cuda_attention.local_attention(q, q, q, 8, halo_k=q[:, :, :8])
    with pytest.raises(ValueError, match="halo must be"):
        cuda_attention._check_halo(q, q[:, :1, :8], q[:, :1, :8], 8)
    with pytest.raises(ValueError, match="halo must be"):
        cuda_attention._check_halo(q, q[:, :, :4], q[:, :, :4], 8)
    with pytest.raises(TypeError, match="dtype"):
        cuda_attention._check_halo(q, q[:, :, :8].double(),
                                   q[:, :, :8].double(), 8)
