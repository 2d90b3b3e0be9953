#!/usr/bin/env python3
"""Drive the PyTorch port (progen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--details PATH]

Phases, one line each:
  1. build the CUDA kernels from progen_tpu_torch/csrc (one nvcc per
     source, all at once), and read, for each bfloat16/float16 kernel of
     the attention (the forward A1/A4 and the backwards' row and key
     passes) and the SGU tail's bfloat16 mix (L2), ptxas's registers and
     spills and the count of tensor-core instructions in its machine code
     (cuobjdump -sass): it fails if one has none, or spills (the
     attention's at d = 64);
  2. at the base model's shapes (configs/model/base.toml), hold each
     kernel against its plain PyTorch version on the card, and time the
     kernel (by CUDA events around back-to-back calls, ``ms``, and by
     its device time under torch.profiler, ``device_ms``, which the share
     of the bound is taken from), the plain version and, where one exists,
     a single PyTorch call computing the same function: L1's calls rotate
     over inputs that overflow the L2 cache; the forward kernels (A1 on the
     tensor cores, beside scaled_dot_product_attention) at the scoring
     batch of 8, the attention backwards A2 (kv-centric) and A3 (halo) at
     the training micro-batch of 4;
  3. the main path, driven once with the launch counts set to 0 just
     before and read just after: the base model (dim 1024, depth 24,
     heads 16, dim_head 64, window 512, seq_len 1024, ~401M parameters,
     random weights from a seed) scores 8 protein strings through
     score_step, one forward that must launch 24 (attention), 48 (norm +
     shift) and 2 (SGU tail) kernels; then sample_fast_batched answers 4
     generation requests (top_k 25, BOS, length 256) with the KV-cache
     decoder, which launches none;
  4. the checks: scores of the expected shape, finite, over the expected
     tokens, with logits that agree with the same model on the plain
     path (each kernel's plain version swapped in by this script); the
     generated sequences well formed, and the decoder's logits in
     agreement with the full forward over their 256 positions;
  5. the train path, with the launch counts set to 0 just before and read
     just after: init_train_state at base (remat on), then 3 optimizer
     steps of make_train_step on (4, 4, 1025) protein batches (the JAX
     CLI's --batch_size 4 --grad_accum_every 4, lr 2e-4, weight decay
     1e-3, clip 0.5): each step must launch A1 192, A2 96, L1 384 and L2
     16 times (remat runs every forward kernel twice a micro-batch);
  6. the checks of the train path: finite losses and grad norms, no
     skipped step, a lower loss on the repeated batch after the 3 steps;
     then, on a batch of the proteins back to back with no padding (so
     every window's rows get a gradient), one micro-batch's gradients
     through the kernels against the plain path and a float32 plain
     model, and one step twice from the same state: with A2 and, on a
     copy of the state, with the attention backward switched to A3
     ("halo"), counted on its own (A3 96, A2 0), whose gradients must
     agree with the A2 step's; then one plain A2 step, profiled by kernel
     group;
  7. seqpar, the sequence-parallel train path at configs/model/long8k.toml
     (dim 512, depth 12, heads 8, window 512, seq_len 8192, 2 gMLP
     layers, remat on, ~184M parameters; nothing cut): first one process
     runs 3 steps of make_train_step on the whole sequence (A1/A2) on a
     (2, 2, 8193) batch of unpadded random tokens, and a float32 model
     the same 3 steps from the same state; then 2 ranks, spawned here,
     share the card over gloo (grid data 1 x seq 2) and run the same 3
     steps of make_train_step(grid) from the same state, in bfloat16 and
     then in float32, each on its 4096 positions of every row, through
     A4 (the attention with its neighbour's halo), L1 with the halo row
     and L2 for its rows. With each rank's counts set to 0 just before
     and read just after, each bfloat16 step must launch A4 48 (forward,
     remat doubles it) and 24 (kv backward), L1 96 and L2 8 times on
     each rank; one more first step on a copy of the state, with the
     attention backward switched to A4's q-centric ("halo") form, must
     launch it 24 times and agree with the kv step's gradients as A3 does
     with A2's in phase 6. Their losses, the first step's gradients and the
     parameters after the 3 steps are held against the single
     process's, float32 against float32 and bfloat16 against bfloat16
     (the rule by SEQPAR_*).
     Two ranks share one card here (NCCL puts one rank on a card), so
     their step time is a record of the path, not a scaling number.

Phase 2 also holds A4 (forward and both backwards, with a halo) against
its plain versions at long8k's shard shapes with 2 shards, and runs the
shard identity: the 8192-token sequence cut in two, each shard with its
halo sliced from the other, through A4 equals A1 and A2/A3 on the whole
sequence (output and dq bit for bit; dk and dv to A2's tolerance once
shard 1's halo gradient is added to shard 0's last window).

Plain-path comparisons run with TF32 off for matrix products and
convolutions (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 are set False). Any failure exits
non-zero. The line before the last holds the card's name and power limit,
the one before it the kernel table as JSON; the last line is the result.
The full results (every kernel row, the main path's checks, profiles of
one forward and one train step by kernel group, the seqpar phase, the
nvcc logs and the tensor-core kernels' ptxas and SASS counts) go to ``--details`` as JSON, by default build/chip_smoke.json.
"""

import argparse
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 8
GEN_LENGTH = 256
TRAIN_ACCUM, TRAIN_MICRO, TRAIN_STEPS = 4, 4, 3
# per parameter tensor, the cosine between the kernel path's gradient and
# the float32 plain model's
GRAD_COS = 0.99
# per parameter tensor, A3's gradient against A2's on the same weights and
# batch: relative distance and cosine. The two backwards differ only in
# the order of dk's and dv's float32 sums before one bfloat16 rounding,
# but the flipped roundings compound through 24 layers of input gradient
# into the embedding's (0.006 on an H100), a tenth of the plain bfloat16
# path's own distance from float32
HALO_REL, HALO_COS = 2e-2, 0.9999
# largest logit gap allowed between the kernel and plain bfloat16 paths of
# the base model (measured 0.136 on an H100: the two round differently)
LOGIT_ATOL = 0.3
# seqpar: grid data 1 x seq 2 on one card, a (2, 2, 8193) batch, 3 steps
SEQ_SHARDS, SEQPAR_ACCUM, SEQPAR_MICRO, SEQPAR_STEPS = 2, 2, 2, 3
SEQPAR_TIMEOUT = 600  # seconds: gloo's collectives and the ranks' join
# seqpar against the single process, by the rule of HALO_REL: the
# sharding may move a result by no more than a tenth of the distance that
# bfloat16 rounding puts between the single process and a float32 model
# taking the same 3 steps from the same state, measured in the same run.
# Three quantities: every step's loss (relative), the first step's
# gradients and the parameters' change over the 3 steps (largest relative
# distance over the tensors). The rule is held in float32, where the
# sharding is the only difference (ranks in float32 against the float32
# single process); in bfloat16 each rank rounds its partial sums (a
# weight's gradient over its half of the tokens) where one process rounds
# the whole sum once, so there the sharded step may be no further from
# the single process than bfloat16 rounding is from float32 (a share of
# 1), and the first step's gradients keep a cosine of at least
# SEQPAR_COS in every tensor
SEQPAR_SHARE_F32, SEQPAR_SHARE_BF16, SEQPAR_COS = 0.1, 1.0, 0.9999
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
L1_COPIES = 4  # inputs L1's timing rotates over (16 MB each at base)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}  # dense tensor-core / float32 FMA rates

PROTEINS = [
    "MQIFVKTLTGKTITLEVEPSDTIENVKAKIQDKEGIPPDQQRLIFAGKQLEDGRTLSDYNIQKESTLHLVLRLRGG",
    "MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSYGVQCFSRYPDHMKQHDFFKSAMPEGYVQERTIFFKDDGNYKTRAEVKFEGDTLVNRIELKGIDFKEDGNILGHKLEYNYNSHNVYIMADKQKNGIKVNFKIRHNIEDGSVQLADHYQQNTPIGDGPVLLPDNHYLSTQSALSKDPNEKRDHMVLLEFVTAAGITHGMDELYK",
    "MALWMRLLPLLALLALWGPDPAAAFVNQHLCGSHLVEALYLVCGERGFFYTPKTRREAEDLQVGQVELGGGPGAGSLQPLALEGSLQKRGIVEQCCTSICSLYQLENYCN",
    "MVLSPADKTNVKAAWGKVGAHAGEYGAEALERMFLSFPTTKTYFPHFDLSHGSAQVKGHGKKVADALTNAVAHVDDMPNALSALSDLHAHKLRVDPVNFKLLSHCLLVTLAAHLPAEFTPAVHASLDKFLASVSTVLTSKYR",
    "KVFGRCELAAAMKRHGLDNYRGYSLGNWVCAAKFESNFNTQATNRNTDGSTDYGILQINSRWWCNDGRTPGSRNLCNIPCSALLSSDITASVNCAKKIVSDGNGMNAWVAWRNRCKGTDVQAWIRGCRL",
    "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVKVKALPDAQFEVVHSLAKWKRQTLGQHDFSAGEGLYTHMKALRPDEDRLSPLHSVYVDQWDWERVMGDGERQFSTLKSTVEAIWAGIKATEAAVSEEFGLAPFLPDQIHFVHSQELLSRYPDLDAKGRERAIAKDLGAVFLVGIGGKLSDGHRHDVRAPDYDDW",
    "MDSKGSSQKGSRLLLLLVVSNLLLCQGVVSTPVCPNGPGNCQVSLRDLFDRAVMVSHYIHDLSSEMFNEFDKRYAQGKGFITMALNSCHTSSLPTPEDKEQAQQTHHEVLMSLILGLLRSWNDPLYHLVTEVRGMKGAPDAILSRAIEIEEENKRLLEGMEMIFGQVIPGAKETEPYPVWSGLPSLQTKDEDARYSAFYNLLHCLRRDSSKIDTYLKLLNCRIIYNNNC",
    "GIVEQCCTSICSLYQLENYCN",
]
PRIMES = ["MKTA", "MSKG", "MALW", "MVLS"]  # one length: one batch


def line(tag: str, **fields) -> None:
    print(f"{tag}: " + json.dumps(fields, default=float), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20):
    """Mean device time of one ``fn()``: the CUDA time of every kernel
    that ``iters`` calls launch, summed by torch.profiler, over
    ``iters``; None when the profiler saw no device time in three tries
    (now and then one records none). Unlike ``time_ms`` it leaves out the
    host's time between launches, which is all of a short kernel's time
    when the host launches slower than the card runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    return None


def kernel_times(fn) -> dict:
    """A kernel's time both ways: ``ms`` by CUDA events around 20
    back-to-back calls, ``device_ms`` by the profiler over 20 calls."""
    return dict(ms=time_ms(fn), device_ms=device_ms(fn))


def check_close(name, got, want, atol, rtol) -> dict:
    """Hold ``got`` against ``want``: every element within atol + rtol *
    |want|. ``max_rel_err`` is taken where the relative term dominates
    (|want| >= atol / rtol); ``worst_over_tolerance`` <= 1 passes."""
    want = want.float()
    diff = (got.float() - want).abs()
    bound = atol + rtol * want.abs()
    big = want.abs() >= atol / rtol
    out = {"max_abs_err": diff.max().item(),
           "max_rel_err": (diff[big] / want.abs()[big]).max().item()
           if bool(big.any()) else 0.0,
           "atol": atol, "rtol": rtol,
           "worst_over_tolerance": (diff / bound).max().item()}
    if not bool(torch.isfinite(got).all()) or not bool((diff <= bound).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: {out}")
    return out


def plain_attention(q, k, v, window_size, scale=None, bwd_impl="kv"):
    """The attention forward's plain version; autograd differentiates it,
    so its backward is plain too."""
    from progen_tpu_torch.ops import cuda_attention

    return cuda_attention.local_attention_fwd_reference(q, k, v,
                                                        window_size, scale)


@contextlib.contextmanager
def plain_path():
    """The model with each kernel's plain version in its place, forward
    and backward, on the card: the yardstick the kernel path is held
    against. The package has no such switch (a CUDA tensor always takes
    the kernel); this script swaps the plain versions in where the
    model's blocks call them."""
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.ops import cuda_layers

    with mock.patch.multiple(
        layers,
        local_attention=plain_attention,
        norm_shift=cuda_layers.norm_shift_reference,
        sgu_mix_gate=cuda_layers.sgu_mix_gate_reference,
    ):
        yield


def bound_ms(nbytes: float, ops: float, dtype) -> dict:
    """The least time of a kernel's work (its bytes moved once over the
    memory rate, or its operations over the peak rate of their type,
    whichever is longer), which of the two sets it, and the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops)


def visible_pairs(n: int, w: int, halo: bool = False) -> int:
    """(query, key) pairs of one head's local attention that a query
    sees: its own window up to itself, and the whole previous window.
    Window 0's phantom zero keys are left out: they add nothing to any
    product. With a halo (A4), window 0's previous window is real."""
    return sum((w if r >= w or halo else 0) + (r % w) + 1 for r in range(n))


def window_mask(n: int, w: int, dev) -> torch.Tensor:
    """(n, w + n) boolean mask of the local attention over keys [w
    previous | n own]: query i sees key j (j from -w) when j <= i and j
    lies in i's window or the one before."""
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :]  # j + w
    return (j - w <= i) & (i // w - j // w <= 0)


def phase_build():
    from progen_tpu_torch.ops import _build

    t = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t
    for name in libs:
        _build.load(name)
    line("build", seconds=seconds, kernels=sorted(libs))
    logs = {name: _build.build_log(name) for name in libs}
    tc = tensor_core_kernels(logs, libs)
    line("tensor-core kernels", **{
        k: v for k, v in tc.items()
        if "bfloat16, 64" in k or "bfloat16, 128" in k or "sgu_" in k})
    bad = [k for k, v in tc.items()
           if v["mma_instructions"] + v["wgmma_instructions"] == 0
           or ((", 64" in k or "sgu_" in k) and v["spill_bytes"] != 0)]
    bad += [f"{kern}<{dt}, 64> not found in the ptxas logs"
            for kern in ("fwd", "rows", "kv", "halo")
            for dt in ("bfloat16", "float16")
            if not any(f"{kern}_tc_kernel<{dt}, 64" in k for k in tc)]
    if not any("sgu_mix_tc_kernel<bfloat16>" in k for k in tc):
        bad.append("sgu_mix_tc_kernel<bfloat16> not found in the ptxas logs")
    if bad:
        raise AssertionError(f"tensor-core kernels missing, without mma "
                             f"or with spills: {bad}")
    return dict(logs=logs, seconds=seconds, tensor_core_kernels=tc)


def tensor_core_kernels(logs: dict, libs: dict) -> dict:
    """For each tensor-core kernel (``*_tc_kernel``: the attention's
    forward and backward passes, keyed "library: kernel<dtype, d,
    halo>", and the SGU tail's mix, "library: sgu_mix_tc_kernel<dtype>"):
    what ptxas reported (registers, spilled bytes, stack frame) and the
    count of tensor-core instructions (HMMA, or HGMMA for wgmma) in its
    machine code, read by cuobjdump -sass from the built library."""
    import re
    import shutil

    def short(entry):
        if "sgu_mix_tc_kernel" in entry:
            dtype = "bfloat16" if "bfloat16" in entry else "float16"
            return f"sgu_mix_tc_kernel<{dtype}>"
        m = re.search(r"((?:fwd|rows|kv|halo)_tc_kernel)I"
                      r"(?:6__half|13__nv_bfloat16)Li(\d+)E(?:Lb([01])E)?",
                      entry)
        dtype = "bfloat16" if "bfloat16" in entry else "float16"
        halo = ", halo" if m.group(3) == "1" else ""
        return f"{m.group(1)}<{dtype}, {m.group(2)}{halo}>"

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, log in logs.items():
        found, entry = {}, None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1) if "_tc_kernel" in m.group(1) else None
                if entry:
                    found[entry] = dict(mma_instructions=0,
                                        wgmma_instructions=0)
            elif entry and "spill stores" in ln:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                    ln)
                found[entry]["spill_bytes"] = int(st) + int(ld)
                found[entry]["stack_frame_bytes"] = int(
                    re.search(r"(\d+) bytes stack frame", ln).group(1))
            elif entry and "registers" in ln:
                found[entry]["registers"] = int(
                    re.search(r"Used (\d+) registers", ln).group(1))
        if not found:
            continue
        sass = subprocess.run([tool, "-sass", str(libs[name])],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1) if m.group(1) in found else None
            elif fn and "HGMMA" in ln:
                found[fn]["wgmma_instructions"] += 1
            elif fn and "HMMA" in ln:
                found[fn]["mma_instructions"] += 1
        out.update({f"{name}: {short(e)}": v for e, v in found.items()})
    return out


def phase_kernels(cfg, cfg8k, card: str) -> list:
    """Each kernel against its plain version at the base shapes. Each
    line gives the launches one forward must make (``per_forward``); the
    counts the main path made are in the ``kernels`` table."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention, cuda_layers

    dev, dt = torch.device("cuda"), cfg.compute_dtype
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    b, h, n, d, w = BATCH, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    esize = torch.finfo(dt).bits // 8

    # A1: local attention forward
    q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    fn = cuda_attention.local_attention_fwd
    ref = cuda_attention.local_attention_fwd_reference
    got = fn(q, k, v, w)
    want = ref(q, k, v, w)
    plain_ms = time_ms(lambda: ref(q, k, v, w), iters=3)
    err = check_close("A1", got, want, 1e-2, 1e-2)
    # one PyTorch call computing the same function: SDPA over keys padded
    # with w zero keys that only window-0 queries see
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    kp, vp = torch.cat([zeros, k], 2), torch.cat([zeros, v], 2)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :] - w
    mask = torch.where(j < 0, i < w,
                       (j <= i) & (i // w - j.clamp_min(0) // w <= 1))
    lib = F.scaled_dot_product_attention(q, kp, vp, attn_mask=mask)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, kp, vp, attn_mask=mask), iters=5)
    bnd = bound_ms(4 * b * h * n * d * esize,
                   2 * 2 * d * visible_pairs(n, w) * b * h, dt)
    rows.append(dict(
        name="local_attention_fwd", id="A1", route="cuda",
        source="progen_tpu_torch/csrc/local_attention_fwd.cu",
        replaces="progen_tpu/ops/pallas_attention.py:552",
        **kernel_times(lambda: fn(q, k, v, w)), plain_ms=plain_ms,
        library_ms=lib_ms, **bnd,
        library_max_abs_err=(lib.float() - want.float()).abs().max().item(),
        shape=[b, h, n, d], window=w, **err,
    ))
    del q, k, v, kp, vp, lib, got, want

    # L1: norm + shift over the residual stream. Its timed calls rotate
    # over L1_COPIES inputs, so that each call finds its input out of the
    # 50 MB L2 cache (the other copies' calls move 3 x 32 MB between two
    # uses of one), as a layer's input is in the model
    xs = [randn(b, n, cfg.dim) * 2 + 0.5 for _ in range(L1_COPIES)]
    x = xs[0]
    scale = torch.rand(cfg.dim, generator=gen, device=dev) + 0.5
    eps = cfg.layer_norm_epsilon
    fn = cuda_layers.norm_shift
    ref = cuda_layers.norm_shift_reference
    got = fn(x, scale, eps, dt)
    want = ref(x, scale, eps, dt)
    plain_ms = time_ms(lambda: ref(x, scale, eps, dt))
    err = check_close("L1", got, want, 1e-2, 1e-2)
    bnd = bound_ms(2 * x.numel() * esize + 4 * cfg.dim, 7 * x.numel(), dt)
    turn = itertools.count()
    rows.append(dict(
        name="norm_shift", id="L1", route="cuda",
        source="progen_tpu_torch/csrc/norm_shift.cu",
        replaces="progen_tpu/ops/pallas_layers.py:193",
        **kernel_times(lambda: fn(xs[next(turn) % L1_COPIES], scale, eps,
                                  dt)),
        plain_ms=plain_ms, library_ms=None, **bnd, shape=list(x.shape),
        inputs_rotated=L1_COPIES, **err,
    ))
    del x, xs, got, want

    # L2: SGU tail, weights at ~1/sqrt(n) so an error in the mix shows
    half = cfg.dim * cfg.ff_mult // 2
    x, gate = randn(b, n, half), randn(b, n, half)
    wts = randn(n, n, dtype=torch.float32) / n ** 0.5
    bias = randn(n, 1, dtype=torch.float32)
    scale = torch.rand(half, generator=gen, device=dev) + 0.5
    fn = cuda_layers.sgu_mix_gate
    ref = cuda_layers.sgu_mix_gate_reference
    got = fn(x, gate, wts, bias, scale, eps, dt)
    want = ref(x, gate, wts, bias, scale, eps, dt)
    plain_ms = time_ms(lambda: ref(x, gate, wts, bias, scale, eps, dt),
                       iters=3)
    err = check_close("L2", got, want, 2e-2, 2e-2)
    # the bound of the card's route for this dtype: in bfloat16 the mix's
    # products run on the tensor cores (W split in two bfloat16 parts is
    # the kernel's cost, not the function's), in float16 and float32 on the
    # FMA units at the float32 rate
    nbytes = 3 * x.numel() * esize + 4 * (n * n + n + half)
    bnd = bound_ms(nbytes, 2 * b * half * n * (n + 1) // 2,
                   dt if dt == torch.bfloat16 else torch.float32)
    rows.append(dict(
        name="sgu_mix_gate", id="L2", route="cuda",
        source="progen_tpu_torch/csrc/sgu_mix_gate.cu",
        replaces="progen_tpu/ops/pallas_layers.py:258",
        **kernel_times(lambda: fn(x, gate, wts, bias, scale, eps, dt)),
        plain_ms=plain_ms, library_ms=None, **bnd, shape=list(x.shape),
        **err,
    ))
    del x, gate, got, want

    rows += backward_rows(cfg, gen)
    rows += halo_rows(cfg8k, gen)
    fwd, step = per_forward(cfg), per_step(cfg)
    sp = seqpar_per_step(cfg8k)
    for r in rows:
        # the bound's operations over the kernel's device time, and the
        # bound's share of that time (of ms where the profiler saw none)
        t = r["device_ms"] or r["ms"]
        r["tflops"] = r["ops"] / (t * 1e-3) / 1e12
        r["share_of_bound"] = r["bound_ms"] / t
        line(f"kernel {r['id']}", **{k: r[k] for k in (
            "name", "shape", "max_abs_err", "max_rel_err", "atol", "rtol",
            "worst_over_tolerance", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "tflops",
            "share_of_bound")},
            launches_per_forward=fwd[r["id"]],
            launches_per_step=step[r["id"]],
            seqpar_launches_per_step_and_rank=sp[r["id"]], card=card)
    line("kernels", status={r["id"]: "ok" for r in rows})
    return rows


def backward_rows(cfg, gen) -> list:
    """A2 and A3 (with its combine) against their plain backwards at the
    base training shapes: micro-batch 4, bh = 64, n 1024, w 512, d 64."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention

    dev, dt = gen.device, cfg.compute_dtype
    b, h, n, d, w = TRAIN_MICRO, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    bh, esize = b * h, torch.finfo(dt).bits // 8
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen,
                               device=dev).to(dt) for _ in range(4))
    # one PyTorch call computing the same function: the backward of
    # scaled_dot_product_attention over keys padded with the w phantom
    # zero keys, which only window-0 queries see (as A1's row builds it),
    # taken as autograd.grad of the retained forward graph
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kp = torch.cat([zeros, leaves[1]], 2)
    vp = torch.cat([zeros, leaves[2]], 2)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(n + w, device=dev)[None, :] - w
    mask = torch.where(j < 0, i < w,
                       (j <= i) & (i // w - j.clamp_min(0) // w <= 1))
    out = F.scaled_dot_product_attention(leaves[0], kp, vp, attn_mask=mask)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                 retain_graph=True))
    del out, kp, vp, leaves
    # the function's least work, one bound for A2 and A3 alike: q, k, v
    # and dO read once, dq, dk and dv written once; five products (S, dP,
    # dV, dQ, dK) of 2·d operations over the (query, key) pairs a query
    # sees. A2's recompute of the next window's rows and A3's float32
    # scratch are the kernels' own cost, not the function's.
    bnd = bound_ms(7 * bh * n * d * esize,
                   5 * 2 * d * visible_pairs(n, w) * bh, dt)
    rows = []
    for rid, impl in (("A2", "kv"), ("A3", "halo")):
        fn = getattr(cuda_attention, f"local_attention_bwd_{impl}")
        ref = getattr(cuda_attention, f"local_attention_bwd_{impl}_reference")
        got = fn(q, k, v, do, w)
        want = ref(q, k, v, do, w)
        errs = [check_close(f"{rid} {g}", a, c, 1e-2, 1e-2)
                for g, a, c in zip(("dq", "dk", "dv"), got, want)]
        err = max(errs, key=lambda e: e["worst_over_tolerance"])
        plain_ms = time_ms(lambda: ref(q, k, v, do, w), iters=3)
        rows.append(dict(
            name=f"local_attention_bwd_{impl}", id=rid, route="cuda",
            source=f"progen_tpu_torch/csrc/local_attention_bwd_{impl}.cu",
            replaces="progen_tpu/ops/pallas_attention.py:"
                     + ("652" if impl == "kv" else "683"),
            **kernel_times(lambda: fn(q, k, v, do, w)), plain_ms=plain_ms,
            library_ms=lib_ms, **bnd, shape=[b, h, n, d], window=w,
            errors=dict(zip(("dq", "dk", "dv"), errs)), **err,
        ))
        del got, want
    return rows


def halo_rows(cfg, gen) -> list:
    """A4, the attention with a halo, against its plain versions at
    long8k's shard shapes with 2 shards: q, k, v, dO (2, 8, 4096, 64) and
    halo_k, halo_v (2, 8, 512, 64) in bfloat16, from a seed; then the
    shard identity on the whole 8192-token sequence."""
    import torch.nn.functional as F

    from progen_tpu_torch.ops import cuda_attention as ca

    dev, dt = gen.device, cfg.compute_dtype
    b, h, d, w = SEQPAR_MICRO, cfg.heads, cfg.dim_head, cfg.window_size
    n = cfg.seq_len // SEQ_SHARDS
    bh, esize = b * h, torch.finfo(dt).bits // 8

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, k, v, do = (randn(b, h, n, d) for _ in range(4))
    hk, hv = randn(b, h, w, d), randn(b, h, w, d)
    # one PyTorch call computing the same function: SDPA over the keys
    # [halo | shard] with the window mask, forward and (autograd.grad of
    # the retained graph) backward
    mask = window_mask(n, w, dev)
    kp, vp = torch.cat([hk, k], 2), torch.cat([hv, v], 2)
    lib_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, kp, vp, attn_mask=mask), iters=5)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(
        leaves[0], torch.cat([hk, leaves[1]], 2),
        torch.cat([hv, leaves[2]], 2), attn_mask=mask)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                     retain_graph=True))
    del out, leaves, kp, vp
    # the least work: inputs (and the halo) read once, outputs written
    # once; the forward's two products over every visible pair, the
    # backward's S, dP and dQ over every visible pair and dK, dV over
    # the shard's own keys (the halo's gradient is halo_grads', outside)
    pairs = visible_pairs(n, w, halo=True) * bh
    own = pairs - w * w * bh
    halo_bytes = 2 * bh * w * d * esize
    fwd_bnd = bound_ms(4 * bh * n * d * esize + halo_bytes,
                       2 * 2 * d * pairs, dt)
    bwd_bnd = bound_ms(7 * bh * n * d * esize + halo_bytes,
                       2 * d * (3 * pairs + 2 * own), dt)
    common = dict(route="cuda",
                  replaces="progen_tpu/ops/pallas_attention.py:731",
                  shape=[b, h, n, d], halo=[b, h, w, d], window=w)

    got = ca.local_attention_halo_fwd(q, k, v, hk, hv, w)
    want = ca.local_attention_halo_fwd_reference(q, k, v, hk, hv, w)
    err = check_close("A4 forward", got, want, 1e-2, 1e-2)
    rows = [dict(
        name="local_attention_halo_fwd", id="A4-fwd",
        source="progen_tpu_torch/csrc/local_attention_fwd.cu",
        **kernel_times(
            lambda: ca.local_attention_halo_fwd(q, k, v, hk, hv, w)),
        plain_ms=time_ms(lambda: ca.local_attention_halo_fwd_reference(
            q, k, v, hk, hv, w), iters=3),
        library_ms=lib_fwd_ms, **fwd_bnd,
        **common, **err)]
    del got, want
    for rid, impl in (("A4-kv", "kv"), ("A4-halo", "halo")):
        fn = getattr(ca, f"local_attention_halo_bwd_{impl}")
        ref = getattr(ca, f"local_attention_halo_bwd_{impl}_reference")
        got = fn(q, k, v, hk, hv, do, w)
        want = ref(q, k, v, hk, hv, do, w)
        errs = [check_close(f"{rid} {g}", a, c, 1e-2, 1e-2)
                for g, a, c in zip(("dq", "dk", "dv"), got, want)]
        rows.append(dict(
            name=f"local_attention_halo_bwd_{impl}", id=rid,
            source=f"progen_tpu_torch/csrc/local_attention_bwd_{impl}.cu",
            **kernel_times(lambda: fn(q, k, v, hk, hv, do, w)),
            plain_ms=time_ms(lambda: ref(q, k, v, hk, hv, do, w), iters=3),
            library_ms=lib_bwd_ms, **bwd_bnd,
            errors=dict(zip(("dq", "dk", "dv"), errs)),
            **common, **max(errs, key=lambda e: e["worst_over_tolerance"])))
        del got, want
    ident = shard_identity(cfg, gen)
    rows[0]["shard_identity"] = ident
    line("shard identity", **ident)
    return rows


def shard_identity(cfg, gen) -> dict:
    """The 8192-token sequence (2, 8, 8192, 64) cut in two shards, shard
    0 with a zero halo (the reference's phantom keys) and shard 1 with
    shard 0's last window, through A4, against A1 and A2/A3 on the whole
    sequence: the output and dq must be bit-equal (one kernel over the
    same keys in the same order, and zero keys of score 0 leave the
    online softmax exactly where the phantom start puts it); dk and dv,
    with shard 1's halo gradient (halo_grads) added to shard 0's last
    window, within A2's tolerance (two bfloat16 roundings there, where
    the whole sequence has one)."""
    from progen_tpu_torch.ops import cuda_attention as ca

    dev, dt = gen.device, cfg.compute_dtype
    b, h, n, d, w = SEQPAR_MICRO, cfg.heads, cfg.seq_len, cfg.dim_head, \
        cfg.window_size
    q, k, v, do = (torch.randn((b, h, n, d), generator=gen,
                               device=dev).to(dt) for _ in range(4))
    m = n // 2
    zeros = torch.zeros(b, h, w, d, dtype=dt, device=dev)
    halos = [(zeros, zeros), (k[:, :, m - w:m], v[:, :, m - w:m])]
    shards = [slice(0, m), slice(m, n)]
    whole = ca.local_attention_fwd(q, k, v, w)
    sharded = torch.cat([ca.local_attention_halo_fwd(
        q[:, :, s], k[:, :, s], v[:, :, s], *hl, w)
        for s, hl in zip(shards, halos)], 2)
    out = dict(shape=[b, h, n, d], shards=2,
               forward_max_abs_diff=(sharded.float() - whole.float())
               .abs().max().item(),
               forward_bit_equal=bool(torch.equal(sharded, whole)))
    del sharded, whole
    for impl in ("kv", "halo"):
        gwhole = getattr(ca, f"local_attention_bwd_{impl}")(q, k, v, do, w)
        bwd = getattr(ca, f"local_attention_halo_bwd_{impl}")
        parts = [list(bwd(q[:, :, s], k[:, :, s], v[:, :, s], *hl,
                          do[:, :, s], w))
                 for s, hl in zip(shards, halos)]
        dhk, dhv = ca.halo_grads(q[:, :, m:], k[:, :, m:], v[:, :, m:],
                                 *halos[1], do[:, :, m:], w)
        parts[0][1][:, :, -w:] += dhk
        parts[0][2][:, :, -w:] += dhv
        for g, a, c in zip(("dq", "dk", "dv"), zip(*parts), gwhole):
            a = torch.cat(a, 2)
            out[f"{impl}_{g}_max_abs_diff"] = (a.float() - c.float()).abs() \
                .max().item()
            out[f"{impl}_{g}_bit_equal"] = bool(torch.equal(a, c))
            check_close(f"shard identity {impl} {g}", a, c, 1e-2, 1e-2)
        del gwhole, parts
    if not (out["forward_bit_equal"] and out["kv_dq_bit_equal"]
            and out["halo_dq_bit_equal"]):
        raise AssertionError(f"shard identity: output or dq not bit-equal "
                             f"to the whole sequence's: {out}")
    return out


def collate(strings, seq_len: int) -> torch.Tensor:
    """Byte-tokenise and pad to (batch, seq_len + 1) with a BOS column."""
    from progen_tpu_torch.data.tokenizer import encode_tokens

    out = torch.zeros(len(strings), seq_len + 1, dtype=torch.long)
    for i, s in enumerate(strings):
        toks = torch.from_numpy(encode_tokens(s)[:seq_len]).long()
        out[i, 1:1 + len(toks)] = toks
    return out


def wrappers() -> dict:
    """Kernel id -> its wrapper, which counts its launches."""
    from progen_tpu_torch.ops import cuda_attention, cuda_layers

    return {"A1": cuda_attention.local_attention_fwd,
            "A2": cuda_attention.local_attention_bwd_kv,
            "A3": cuda_attention.local_attention_bwd_halo,
            "A4-fwd": cuda_attention.local_attention_halo_fwd,
            "A4-kv": cuda_attention.local_attention_halo_bwd_kv,
            "A4-halo": cuda_attention.local_attention_halo_bwd_halo,
            "L1": cuda_layers.norm_shift,
            "L2": cuda_layers.sgu_mix_gate}


def launch_counts() -> dict:
    return {rid: fn.launches for rid, fn in wrappers().items()}


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def per_forward(cfg) -> dict:
    """Launches of one forward on the whole sequence."""
    return {"A1": cfg.depth, "A2": 0, "A3": 0, "A4-fwd": 0, "A4-kv": 0,
            "A4-halo": 0, "L1": 2 * cfg.depth, "L2": cfg.global_mlp_depth}


def per_step(cfg, impl: str = "kv", accum: int = TRAIN_ACCUM) -> dict:
    """Launches of one train step: with remat each forward kernel runs in
    the forward and again in the recompute, once a micro-batch; the
    attention backward once a layer and micro-batch."""
    fwd = {k: v * accum * (2 if cfg.remat else 1)
           for k, v in per_forward(cfg).items()}
    bwd = cfg.depth * accum
    return {**fwd, "A2": bwd if impl == "kv" else 0,
            "A3": bwd if impl == "halo" else 0}


def seqpar_per_step(cfg) -> dict:
    """Launches of one seqpar step on each rank: every attention is A4
    (the halo kernels; rank 0's halo is zeros), A4's kv backward once a
    layer and micro-batch, the forward kernels twice with remat."""
    fwd = SEQPAR_ACCUM * (2 if cfg.remat else 1)
    return {"A1": 0, "A2": 0, "A3": 0, "A4-fwd": cfg.depth * fwd,
            "A4-kv": cfg.depth * SEQPAR_ACCUM, "A4-halo": 0,
            "L1": 2 * cfg.depth * fwd, "L2": cfg.global_mlp_depth * fwd}


def drive_main_path(cfg, model, batch, primes) -> dict:
    """The main path as a user drives it, with every launch count set to
    0 just before and read just after: score_step on the scoring batch
    (one full forward through the kernels), then sample_fast_batched
    answering the generation requests (the KV-cache decoder, which runs no
    kernel)."""
    from progen_tpu_torch.sampling import sample_fast_batched
    from progen_tpu_torch.workloads.scoring import score_step

    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    scores = score_step(model, batch, device="cuda")
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t
    scored = launch_counts()
    t = time.perf_counter()
    seqs = sample_fast_batched(0, model, primes, GEN_LENGTH, top_k=25,
                               add_bos=True, device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    counts = launch_counts()
    want = per_forward(cfg)
    if scored != want or counts != want:
        raise AssertionError(f"main path launched {scored} while scoring "
                             f"and {counts} in all, not {want}")
    return dict(scores=scores, score_s=score_s, seqs=seqs, gen_s=gen_s,
                launches=counts)


def check_scores(cfg, model, model32, batch, run) -> dict:
    """Phase 3's checks: shapes, finite values, the scored token counts,
    and logits that agree with the same model on the plain path."""
    nll, lp, mask = run["scores"]
    if nll.shape != (BATCH,) or lp.shape != (BATCH, cfg.seq_len):
        raise AssertionError("score_step shapes")
    if not bool(torch.isfinite(nll).all() & torch.isfinite(lp).all()):
        raise AssertionError("non-finite scores")
    ntok = [int(m.sum()) for m in mask]
    expect = [min(len(s) + 1, cfg.seq_len) for s in PROTEINS]
    if ntok != expect:
        raise AssertionError(f"scored token counts {ntok} != {expect}")

    from progen_tpu_torch.training.loss import sequence_scores

    ids, labels = batch[:, :-1].cuda(), batch[:, 1:].cuda()
    with torch.inference_mode():
        got = model(ids)
        with plain_path():
            plain = model(ids)
            ref32 = model32(ids)
    e_k = (got - ref32).abs().max().item()
    e_p = (plain - ref32).abs().max().item()
    d_kp = (got - plain).abs().max().item()
    d_nll = (nll - sequence_scores(plain, labels)[0]).abs().max().item()
    # The kernel path may be no further from the float32 forward than
    # twice the plain bfloat16 path's distance (both round activations to
    # bfloat16 at every layer), no logit further than LOGIT_ATOL from the
    # plain path's, and its per-sequence NLL within 1e-2 nats.
    if (not e_k <= 2 * e_p + 1e-3 or not d_kp <= LOGIT_ATOL
            or not d_nll <= 1e-2):
        raise AssertionError(f"logits: kernel vs f32 {e_k}, plain vs f32 "
                             f"{e_p}, kernel vs plain {d_kp}, nll {d_nll}")
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(ids), iters=5, warmup=1)
        with plain_path():
            plain_fwd_ms = time_ms(lambda: model(ids), iters=3, warmup=1)
    out = dict(score_step_s=run["score_s"], forward_ms=fwd_ms,
               plain_forward_ms=plain_fwd_ms,
               sequences_per_s=BATCH / (fwd_ms / 1e3), tokens=ntok,
               mean_nll=nll.mean().item(), logits_kernel_vs_plain=d_kp,
               logits_kernel_vs_f32=e_k, logits_plain_vs_f32=e_p,
               nll_kernel_vs_plain=d_nll)
    line("score", **out)
    return out


KERNEL_GROUPS = (  # kernel-name substring -> group in the breakdown
    # A1: the float32 FMA kernel, then the bfloat16/float16 tensor-core one
    ("local_attention_fwd", "A1 local_attention_fwd"),
    ("fwd_tc_kernel", "A1 local_attention_fwd"),
    # the row pass and the key pass of A2 (the profiled step runs "kv"):
    # the float32 FMA kernels, then the bfloat16/float16 tensor-core ones,
    # ahead of the matrix-product names
    ("rows_kernel", "A2 local_attention_bwd_kv"),
    ("kv_kernel", "A2 local_attention_bwd_kv"),
    ("halo_kernel", "A3 local_attention_bwd_halo"),
    ("rows_tc_kernel", "A2 local_attention_bwd_kv"),
    ("kv_tc_kernel", "A2 local_attention_bwd_kv"),
    ("halo_tc_kernel", "A3 local_attention_bwd_halo"),
    ("norm_shift", "L1 norm_shift"),
    ("sgu_", "L2 sgu_mix_gate"),
    ("nvjet", "matrix products"), ("gemm", "matrix products"),
    ("xmma", "matrix products"), ("cutlass", "matrix products"),
)


def profile_forward(model, ids) -> dict:
    """One full forward under torch.profiler (see ``profile_groups``)."""
    with torch.inference_mode():
        model(ids)
        torch.cuda.synchronize()
        return profile_groups(lambda: model(ids), "profile")


def profile_groups(fn, tag: str) -> dict:
    """``fn()`` once under torch.profiler: device time by kernel group,
    the wall time, and the share of it the card sat idle. Reports "not
    measured" when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        group = next((g for key, g in KERNEL_GROUPS if key in e.key.lower()),
                     "other (elementwise, copies, reductions)")
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, e.count, e.key[:90]))
    device_ms = sum(groups.values())
    if device_ms == 0:
        out = dict(wall_ms=wall_ms, device_ms="not measured")
    else:
        out = dict(wall_ms=wall_ms, device_ms=device_ms,
                   idle_share=max(0.0, 1 - device_ms / wall_ms),
                   by_group={g: groups[g] for g in sorted(
                       groups, key=groups.get, reverse=True)},
                   top_kernels=[dict(ms=m, count=c, name=n) for m, c, n
                                in sorted(top, reverse=True)[:12]])
    line(tag, **{k: v for k, v in out.items() if k != "top_kernels"})
    return out


def check_generation(cfg, model, model32, primes, run) -> dict:
    """Phase 4's checks: shapes, token range, BOS and prime kept, nothing
    after the second zero, and decode-mode logits that agree with the
    full forward over the generated positions."""
    seqs = run["seqs"]
    if seqs.shape != (len(PRIMES), GEN_LENGTH) or seqs.device.type != "cuda":
        raise AssertionError(f"sample shape {tuple(seqs.shape)}")
    if int(seqs.min()) < 0 or int(seqs.max()) >= cfg.num_tokens:
        raise AssertionError("token out of range")
    if not bool((seqs[:, 0] == 0).all()):
        raise AssertionError("BOS missing")
    if not torch.equal(seqs[:, 1:1 + primes.shape[1]].cpu(),
                       torch.from_numpy(primes).long()):
        raise AssertionError("prime not kept")
    after = torch.cumsum((seqs == 0).long(), dim=-1) > 1
    if bool((seqs[after] != 0).any()):
        raise AssertionError("tokens after the second zero")

    with torch.inference_mode():
        cache = model.init_cache(seqs.shape[0])
        dec = torch.stack([model.decode_step(seqs[:, p], cache)
                           for p in range(GEN_LENGTH)], dim=1)
        padded = torch.zeros(seqs.shape[0], cfg.seq_len, dtype=torch.long,
                             device=seqs.device)
        padded[:, :GEN_LENGTH] = seqs
        full = model(padded)[:, :GEN_LENGTH]
        with plain_path():
            plain = model(padded)[:, :GEN_LENGTH]
            ref32 = model32(padded)[:, :GEN_LENGTH]
    e_dec = (dec - ref32).abs().max().item()
    e_p = (plain - ref32).abs().max().item()
    d_df = (dec - full).abs().max().item()
    # same rule as the scoring check: the decoder, in bfloat16, no further
    # from the float32 full forward than twice the plain bfloat16 forward
    if not e_dec <= 2 * e_p + 1e-3:
        raise AssertionError(f"decode vs f32 {e_dec}, plain vs f32 {e_p}, "
                             f"decode vs full {d_df}")
    lengths = [int((~after[i]).sum()) for i in range(seqs.shape[0])]
    steps = GEN_LENGTH - 1  # decode steps per request, prefill included
    out = dict(requests=seqs.shape[0], length=GEN_LENGTH,
               seconds=run["gen_s"], decode_steps_per_s=steps / run["gen_s"],
               tokens_per_s=seqs.shape[0] * steps / run["gen_s"],
               lengths=lengths, decode_vs_full=d_df, decode_vs_f32=e_dec,
               plain_vs_f32=e_p)
    line("generate", **out)
    return out


def train_batch(cfg) -> torch.Tensor:
    """(grad_accum, micro_batch, seq_len + 1): the script's proteins,
    byte-tokenised and padded, twice over in two orders."""
    strings = PROTEINS + PROTEINS[::-1]
    return collate(strings, cfg.seq_len).reshape(
        TRAIN_ACCUM, TRAIN_MICRO, cfg.seq_len + 1).cuda()


def full_batch(cfg) -> torch.Tensor:
    """(grad_accum, micro_batch, seq_len + 1) with no padding: the
    proteins back to back, cut into rows after a BOS. Every position
    counts in the loss, so every query row of every window gets a
    gradient (in a padded batch, the rows past a sequence's first pad get
    none: they are masked out of the loss and nothing before them reads
    them)."""
    from progen_tpu_torch.data.tokenizer import encode_tokens

    rows, n = TRAIN_ACCUM * TRAIN_MICRO, cfg.seq_len
    stream = np.concatenate([encode_tokens(s) for s in PROTEINS])
    stream = np.tile(stream, rows * n // len(stream) + 1)[:rows * n]
    out = torch.zeros(rows, n + 1, dtype=torch.long)
    out[:, 1:] = torch.from_numpy(stream.reshape(rows, n).astype(np.int64))
    return out.reshape(TRAIN_ACCUM, TRAIN_MICRO, n + 1).cuda()


def drive_train_path(cfg, state, batch) -> dict:
    """Phase 5, the train path as a user drives it: 3 steps of
    make_train_step on one batch, with every launch count set to 0 just
    before and read just after. Times each step with CUDA events and
    takes the peak device memory over the steps."""
    from progen_tpu_torch.training.step import make_eval_step, make_train_step

    step, evaluate = make_train_step(), make_eval_step()
    loss_before = evaluate(state, batch[0]).item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        steps.append(dict(ms=start.elapsed_time(end),
                          **{k: v.item() for k, v in m.items()}))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TRAIN_STEPS for k, v in per_step(cfg).items()}
    if counts != want:
        raise AssertionError(f"train path launched {counts}, not {want}")
    loss_after = evaluate(state, batch[0]).item()
    tokens = TRAIN_ACCUM * TRAIN_MICRO * cfg.seq_len
    warm = [s["ms"] for s in steps[1:]]
    out = dict(steps=steps, launches=counts,
               launches_per_step=per_step(cfg),
               step_ms=sum(warm) / len(warm),
               tokens_per_s=tokens / (sum(warm) / len(warm) / 1e3),
               first_step_ms=steps[0]["ms"], tokens_per_step=tokens,
               peak_memory_bytes=peak, loss_before=loss_before,
               loss_after=loss_after)
    line("train", **{k: v for k, v in out.items() if k != "steps"})
    for i, st in enumerate(steps):
        line(f"train step {i + 1}", **st)
    return out


def rel_cos(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(|a - b| / |b|, cosine of a and b), over the whole tensor."""
    a, b = a.double().flatten(), b.double().flatten()
    nb = b.norm().item()
    rel = (a - b).norm().item() / nb if nb > 0 else (a - b).norm().item()
    cos = (a @ b).item() / max(a.norm().item() * nb, 1e-300)
    return rel, cos


def grads_of(model, data) -> dict:
    """One micro-batch's gradients of the train loss."""
    from progen_tpu_torch.training.step import batch_loss

    model.zero_grad(set_to_none=True)
    batch_loss(model, data).backward()
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def check_gradients(cfg, state, batch) -> dict:
    """Phase 6a: one micro-batch's gradients through the kernels against
    the same model on the plain path (bfloat16) and a float32 plain
    model. Per parameter tensor, the kernel path's relative distance from
    the float32 gradient may be at most twice the plain bfloat16 path's
    (plus 1e-3), and its cosine with it at least GRAD_COS."""
    from progen_tpu_torch import ProGen

    model = state.model
    model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                     device="cuda", seed=None)
    model32.load_state_dict(model.state_dict())
    data = batch[0]
    got = grads_of(model, data)
    with plain_path():
        plain = grads_of(model, data)
        ref32 = grads_of(model32, data)
    del model32
    worst, bad = [], []
    for name in got:
        rel_k, cos_k = rel_cos(got[name], ref32[name])
        rel_p, _ = rel_cos(plain[name], ref32[name])
        worst.append((rel_k - 2 * rel_p, name, rel_k, rel_p, cos_k))
        if not (rel_k <= 2 * rel_p + 1e-3 and cos_k >= GRAD_COS):
            bad.append((name, rel_k, rel_p, cos_k))
    worst.sort(reverse=True)
    out = dict(tensors=len(got), min_cos=min(w[4] for w in worst),
               max_rel_kernel=max(w[2] for w in worst),
               max_rel_plain=max(w[3] for w in worst),
               worst=[dict(name=w[1], rel_kernel=w[2], rel_plain=w[3],
                           cos=w[4]) for w in worst[:5]])
    line("grad check", **{k: v for k, v in out.items() if k != "worst"},
         worst=out["worst"][0])
    if bad:
        raise AssertionError(f"kernel-path gradients off: {bad[:5]}")
    return out


def step_grads(step, state, batch) -> tuple:
    """One ``step(state, batch)``; returns the averaged, unclipped
    gradients it hands the optimizer, and its metrics."""
    sink, update = [], state.optimizer.update

    def record(grads, norm=None):
        sink.append({n: g.clone() for n, g in grads.items()})
        return update(grads, norm)

    with mock.patch.object(state.optimizer, "update", record):
        _, m = step(state, batch)
    return sink[0], m


def halo_step(cfg, state, batch) -> dict:
    """Phase 6b: the same step from one state twice, with A2 and, on a
    copy of the state, with the attention backward switched to A3, whose
    launches are counted on their own. The gradients the two hand to the
    optimizer must agree per tensor (HALO_REL, HALO_COS). Then one more A2
    step, with nothing recorded, profiled by kernel group."""
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.training.step import make_train_step

    step, twin = make_train_step(), copy.deepcopy(state)
    kv, _ = step_grads(step, state, batch)
    reset_counts()
    with mock.patch.object(layers, "ATTN_BWD_IMPL", "halo"):
        halo, m = step_grads(step, twin, batch)
        torch.cuda.synchronize()
    counts = launch_counts()
    del twin
    want = per_step(cfg, "halo")
    if counts != want:
        raise AssertionError(f"halo step launched {counts}, not {want}")
    stats = [(*rel_cos(halo[n], kv[n]), n) for n in kv]
    rel = max(stats)
    cos = min(stats, key=lambda x: x[1])
    out = dict(launches=counts, max_rel=rel[0], max_rel_tensor=rel[2],
               min_cos=cos[1], min_cos_tensor=cos[2],
               tensors_differing=sum(not torch.equal(halo[n], kv[n])
                                     for n in kv), tensors=len(kv),
               loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
               skipped=int(m["skipped"]))
    line("halo step", **out)
    if not (rel[0] <= HALO_REL and cos[1] >= HALO_COS):
        raise AssertionError(f"A3 step's gradients off A2's: {out}")
    del kv, halo
    profile = profile_groups(lambda: step(state, batch), "train profile")
    return dict(out, profile=profile)


def long8k_config():
    from progen_tpu_torch import ProGenConfig, load_toml_config

    return ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "long8k.toml")))


def seqpar_batch(cfg) -> torch.Tensor:
    """(2, 2, seq_len + 1) random tokens 1..255 from a numpy seed: no pad,
    so every position counts in the loss and every window's rows get a
    gradient."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        1, cfg.num_tokens, (SEQPAR_ACCUM, SEQPAR_MICRO, cfg.seq_len + 1)))


def timed_steps(step, state, batch) -> dict:
    """SEQPAR_STEPS steps of ``step`` with every launch count set to 0
    just before: each step's CUDA-event time, metrics and launches; the
    first step's gradients (as the optimizer gets them) and the peak
    device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps, grads = [], None
    for i in range(SEQPAR_STEPS):
        before = launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if i == 0:
            grads, m = step_grads(step, state, batch)
        else:
            _, m = step(state, batch)
        end.record()
        torch.cuda.synchronize()
        after = launch_counts()
        steps.append(dict(ms=start.elapsed_time(end),
                          launches={k: after[k] - before[k] for k in after},
                          **{k: v.item() for k, v in m.items()}))
    warm = [st["ms"] for st in steps[1:]]
    return dict(grads=grads, steps=steps, launches=launch_counts(),
                step_ms=sum(warm) / len(warm),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def time_all_reduce(cfg, grid) -> float:
    """Host time of the train step's one bucketed gradient all_reduce
    (every parameter's shape, float32) over gloo, on the card, mean of 3
    after one warm-up."""
    from progen_tpu_torch import ProGen
    from progen_tpu_torch.parallel.collectives import all_reduce_

    grads = [torch.zeros_like(p) for p in
             ProGen(cfg, device="cuda", seed=None).parameters()]
    all_reduce_(grads, grid.world_group)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        all_reduce_(grads, grid.world_group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / 3 * 1e3


def seqpar_rank(rank: int, port: int, out_dir: str) -> None:
    """One of the SEQ_SHARDS ranks of phase 7, spawned: joins the gloo
    group and runs the 3 steps of make_train_step(grid) on its shard, in
    bfloat16 (the path, counted) and then in float32 from the same
    state; before them, the first bfloat16 step once more on a copy of
    the state with A4's q-centric ("halo") backward, counted on its own
    and held against the kv step's gradients (HALO_REL, HALO_COS). Writes
    its records, and rank 0 also the gradients of the first step and the
    parameters after the third."""
    import hashlib

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(SEQ_SHARDS),
                      GLOO_SOCKET_IFNAME="lo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.parallel import init_grid
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    grid = init_grid(1, SEQ_SHARDS, "gloo", timeout=SEQPAR_TIMEOUT)
    cfg = long8k_config()
    batch = seqpar_batch(cfg).cuda()
    records = {"gradient_all_reduce_ms": time_all_reduce(cfg, grid)}
    for name, c in (("bf16", cfg),
                    ("f32", dataclasses.replace(cfg, dtype="float32"))):
        state = init_train_state(c, device="cuda", seed=0, grid=grid)
        if name == "bf16":
            # A4's q-centric backward: the first step on a copy of the
            # state with the attention backward switched to "halo",
            # counted on its own
            reset_counts()
            with mock.patch.object(layers, "ATTN_BWD_IMPL", "halo"):
                halo_grads, _ = step_grads(make_train_step(grid),
                                           copy.deepcopy(state), batch)
                torch.cuda.synchronize()
            halo_counts = launch_counts()
        run = timed_steps(make_train_step(grid), state, batch)
        if name == "bf16":
            stats = [(*rel_cos(halo_grads[n], run["grads"][n]), n)
                     for n in halo_grads]
            records["halo_step"] = dict(
                launches=halo_counts, max_rel=max(stats)[0],
                max_rel_tensor=max(stats)[2],
                min_cos=min(stats, key=lambda x: x[1])[1])
            del halo_grads
        params = {n: p.detach()
                  for n, p in state.model.named_parameters()}
        digest = hashlib.sha256()
        for p in params.values():
            digest.update(p.cpu().numpy().tobytes())
        if rank == 0:
            torch.save({"grads": run["grads"], "params": params},
                       Path(out_dir) / f"rank0_{name}.pt")
        records[name] = dict({k: v for k, v in run.items()
                              if k != "grads"},
                             params_sha256=digest.hexdigest())
        del state, run, params
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(dict(
        records, rank=rank, seq_index=grid.seq_index)))
    torch.distributed.destroy_process_group()


def spawn_seqpar(out_dir: Path) -> list:
    """Start the ranks, wait for them within SEQPAR_TIMEOUT, kill any
    left; fail unless every rank exited 0. Their records, in rank
    order."""
    import torch.multiprocessing as mp

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=seqpar_rank, args=(r, port, str(out_dir)))
             for r in range(SEQ_SHARDS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SEQPAR_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"seqpar ranks exited {codes}")
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(SEQ_SHARDS)]


def max_rel(got: dict, want: dict) -> tuple:
    """(largest per-tensor relative distance, its tensor, smallest
    cosine, its tensor) of ``got`` against ``want``."""
    stats = [(*rel_cos(got[n], want[n]), n) for n in want]
    rel = max(stats)
    cos = min(stats, key=lambda x: x[1])
    return rel[0], rel[2], cos[1], cos[2]


def phase_seqpar(cfg, card: str) -> dict:
    """Phase 7 (see the module docstring)."""
    from progen_tpu_torch.training.step import (
        init_train_state,
        make_train_step,
    )

    torch.cuda.empty_cache()
    batch = seqpar_batch(cfg).cuda()
    single = {}
    for name, c in (("bf16", cfg),
                    ("f32", dataclasses.replace(cfg, dtype="float32"))):
        state = init_train_state(c, device="cuda", seed=0)
        if name == "bf16":
            p0 = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        single[name] = timed_steps(make_train_step(), state, batch)
        single[name]["params"] = {n: p.detach() for n, p in
                                  state.model.named_parameters()}
        del state

    out_dir = REPO / "build" / "seqpar"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    t = time.perf_counter()
    ranks = spawn_seqpar(out_dir)
    ranks_s = time.perf_counter() - t

    def delta(params):
        return {n: params[n] - p0[n] for n in p0}

    def loss_rel(a, b):
        return max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                   for x, y in zip(a, b))

    # the bfloat16 single process's own distance from float32
    own = dict(loss=loss_rel(single["bf16"]["steps"],
                             single["f32"]["steps"]),
               grads=max_rel(single["bf16"]["grads"],
                             single["f32"]["grads"])[0],
               update=max_rel(delta(single["bf16"]["params"]),
                              delta(single["f32"]["params"]))[0])
    dist = {}
    for name in ("bf16", "f32"):
        got = torch.load(out_dir / f"rank0_{name}.pt", map_location="cuda")
        dist[name] = dict(
            loss=max(loss_rel(r[name]["steps"], single[name]["steps"])
                     for r in ranks),
            grads=max_rel(got["grads"], single[name]["grads"]),
            update=max_rel(delta(got["params"]),
                           delta(single[name]["params"])))
        del got
    bf = single["bf16"]
    tokens = SEQPAR_ACCUM * SEQPAR_MICRO * cfg.seq_len
    out = dict(
        config="configs/model/long8k.toml", grid=[1, SEQ_SHARDS],
        backend="gloo", batch=list(batch.shape), ranks_s=ranks_s,
        launches_per_step_and_rank=[[st["launches"]
                                     for st in r["bf16"]["steps"]]
                                    for r in ranks],
        step_ms_per_rank=[r["bf16"]["step_ms"] for r in ranks],
        tokens_per_s=tokens / (max(r["bf16"]["step_ms"] for r in ranks)
                               / 1e3),
        peak_memory_bytes_per_rank=[r["bf16"]["peak_memory_bytes"]
                                    for r in ranks],
        gradient_all_reduce_ms_per_rank=[r["gradient_all_reduce_ms"]
                                         for r in ranks],
        halo_step=ranks[0]["halo_step"],
        single_step_ms=bf["step_ms"],
        single_tokens_per_s=tokens / (bf["step_ms"] / 1e3),
        single_peak_memory_bytes=bf["peak_memory_bytes"],
        single_launches=bf["launches"],
        losses=[st["loss"] for st in ranks[0]["bf16"]["steps"]],
        single_losses=[st["loss"] for st in bf["steps"]],
        f32_losses=[st["loss"] for st in single["f32"]["steps"]],
        grad_norms=[st["grad_norm"] for st in ranks[0]["bf16"]["steps"]],
        single_grad_norms=[st["grad_norm"] for st in bf["steps"]],
        bf16_vs_f32=own, card=card,
        note="2 ranks share 1 card: the step time records the path, "
             "it is not a scaling number")
    for name in ("bf16", "f32"):
        d = dist[name]
        out[f"seqpar_vs_single_{name}"] = dict(
            loss=d["loss"], grads_max_rel=d["grads"][0],
            grads_max_rel_tensor=d["grads"][1],
            grads_min_cos=d["grads"][2], grads_min_cos_tensor=d["grads"][3],
            update_max_rel=d["update"][0],
            update_max_rel_tensor=d["update"][1],
            update_min_cos=d["update"][2],
            replicas_equal=len({r[name]["params_sha256"]
                                for r in ranks}) == 1)
    line("seqpar", **out)
    del p0, single
    bad = []
    want_step = seqpar_per_step(cfg)
    want_halo = {**want_step, "A4-kv": 0, "A4-halo": want_step["A4-kv"]}
    for r in ranks:
        hs = r["halo_step"]
        if hs["launches"] != want_halo:
            bad.append(f"rank {r['rank']} halo step launched "
                       f"{hs['launches']}, not {want_halo}")
        if not (hs["max_rel"] <= HALO_REL and hs["min_cos"] >= HALO_COS):
            bad.append(f"rank {r['rank']} halo step's gradients off the "
                       f"kv step's: {hs}")
        for i, st in enumerate(r["bf16"]["steps"]):
            if st["launches"] != want_step:
                bad.append(f"rank {r['rank']} step {i + 1} launched "
                           f"{st['launches']}, not {want_step}")
        for name in ("bf16", "f32"):
            for i, st in enumerate(r[name]["steps"]):
                if not (np.isfinite(st["loss"]) and st["skipped"] == 0):
                    bad.append(f"rank {r['rank']} {name} step {i + 1}: "
                               f"{st}")
    want_single = {k: v * SEQPAR_STEPS for k, v in
                   per_step(cfg, accum=SEQPAR_ACCUM).items()}
    if bf["launches"] != want_single:
        bad.append(f"single process launched {bf['launches']}, not "
                   f"{want_single}")
    for name, share in (("f32", SEQPAR_SHARE_F32),
                        ("bf16", SEQPAR_SHARE_BF16)):
        if not out[f"seqpar_vs_single_{name}"]["replicas_equal"]:
            bad.append(f"the ranks' {name} parameters differ")
        for key in ("loss", "grads", "update"):
            d = dist[name][key] if key == "loss" else dist[name][key][0]
            if not d <= share * own[key]:
                bad.append(f"{name} {key}: {d} from the single process, "
                           f"over {share} x bfloat16's {own[key]} from "
                           f"float32")
    if not dist["bf16"]["grads"][2] >= SEQPAR_COS:
        bad.append(f"gradient cosine {dist['bf16']['grads'][2]} < "
                   f"{SEQPAR_COS}")
    if bad:
        raise AssertionError("seqpar: " + "; ".join(bad))
    return dict(out, launches={k: sum(r["bf16"]["launches"][k]
                                      + r["halo_step"]["launches"][k]
                                      for r in ranks)
                               for k in ranks[0]["bf16"]["launches"]})


def check_training(run: dict) -> None:
    """Phase 6c: every loss and grad norm finite, no step refused, and a
    lower loss on the repeated batch after the steps than before."""
    for st in run["steps"]:
        if not (np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
                and st["skipped"] == 0):
            raise AssertionError(f"train step not finite or skipped: {st}")
    if not run["loss_after"] < run["loss_before"]:
        raise AssertionError(f"loss did not fall: {run['loss_before']} -> "
                             f"{run['loss_after']}")


def main() -> int:
    parser = argparse.ArgumentParser(
        description="Drive the PyTorch port on one NVIDIA card.")
    parser.add_argument("--details", type=Path,
                        default=REPO / "build" / "chip_smoke.json",
                        help="where to write the full results as JSON")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from progen_tpu_torch import ProGen, ProGenConfig, load_toml_config
    from progen_tpu_torch.data.tokenizer import encode_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    build = phase_build()
    cfg = ProGenConfig.from_dict(load_toml_config(
        str(REPO / "configs" / "model" / "base.toml")))
    cfg8k = long8k_config()
    rows = phase_kernels(cfg, cfg8k, card)

    t = time.perf_counter()
    model = ProGen(cfg, device="cuda", seed=0).eval()
    model32 = ProGen(dataclasses.replace(cfg, dtype="float32"),
                     device="cuda", seed=None).eval()
    model32.load_state_dict(model.state_dict())
    line("model", params=sum(p.numel() for p in model.parameters()),
         num_params=cfg.num_params(), init_s=time.perf_counter() - t)

    batch = collate(PROTEINS, cfg.seq_len)
    primes = np.stack([encode_tokens(s) for s in PRIMES])
    run = drive_main_path(cfg, model, batch, primes)
    result = {"launches": run["launches"],
              "score": check_scores(cfg, model, model32, batch, run),
              "generate": check_generation(cfg, model, model32, primes, run),
              "profile": profile_forward(model, batch[:, :-1].cuda())}
    del model, model32

    from progen_tpu_torch.training.step import init_train_state

    t = time.perf_counter()
    state = init_train_state(cfg, device="cuda", seed=0)
    line("train state", params=state.num_params(),
         init_s=time.perf_counter() - t, remat=cfg.remat)
    train = drive_train_path(cfg, state, train_batch(cfg))
    check_training(train)
    result["train"] = train
    fbatch = full_batch(cfg)
    result["grad_check"] = check_gradients(cfg, state, fbatch)
    result["halo_step"] = halo_step(cfg, state, fbatch)
    del state, fbatch
    result["seqpar"] = phase_seqpar(cfg8k, card)

    # each kernel's launches, summed over the paths driven with counts:
    # scoring + generation, the 3 train steps, the A3 step, and the seqpar
    # ranks' 3 steps and A4 halo-backward step (the single-process
    # comparison there is left out)
    paths = dict(inference=run["launches"], train=train["launches"],
                 halo_step=result["halo_step"]["launches"],
                 seqpar=result["seqpar"]["launches"])
    counts = {k: sum(c[k] for c in paths.values()) for k in run["launches"]}
    line("launches", **paths, total=counts)
    if not all(counts.values()):
        raise AssertionError(f"a kernel was never launched: {counts}")
    table = [{
        "name": r["name"], "route": r["route"], "source": r["source"],
        "replaces": r["replaces"], "launches": counts[r["id"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for r in rows]
    args.details.parent.mkdir(parents=True, exist_ok=True)
    args.details.write_text(json.dumps(
        {"card": card, "kernels": rows, "main_path": result,
         "build": build}, indent=1, default=float))
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
