// Shared half of the two local-attention backward kernels
// (local_attention_bwd_kv.cu, A2, replacing pallas_attention.py's
// _bwd_kv_kernel_batched, and local_attention_bwd_halo.cu, A3, replacing
// _bwd_kernel) in float32: the row pass, which both launch first, and the
// helpers of their float32 key passes. bfloat16 and float16 take the
// tensor-core kernels of local_attention_bwd_tc.cuh instead; what follows
// describes the function both implement and the float32 design.
//
// The function is the forward of local_attention_fwd.cu: query row a of
// window i sees the keys of [window i-1 | window i] with concatenated
// index j <= a + w; window 0's previous window is w zero keys (score 0,
// value 0) that still count in the softmax. With dO the output's
// gradient, per query row r and visible key c:
//   p[r, c]  = exp(s[r, c] - m[r]) / l[r],   s = scale * q_r . k_c
//   dp[r, c] = dO_r . v_c
//   delta[r] = sum_c p[r, c] * dp[r, c]      (float32, as _ds_from does)
//   ds[r, c] = p[r, c] * (dp[r, c] - delta[r])
//   dq_r = scale * sum_c ds[r, c] k_c
//   dk_c = scale * sum_r ds[r, c] q_r,   dv_c = sum_r p[r, c] dO_r
// A row's softmax needs all 2w of its keys, including keys outside the
// window a backward block owns. So the row pass computes, for every query
// row, its running max m, its denominator l and delta, into a float32
// (bh, n, 4) scratch, and dq; the kv-centric or halo pass then recomputes
// p and ds from those statistics.
//
// The phantom keys of window 0 enter the statistics as a running max that
// starts at 0 and a denominator that starts at w, exactly as in the
// forward kernel. They add nothing to dq (k = 0) or to delta (v = 0, so
// dp = 0).
//
// With a halo (A4: hk, hv of (bh, w, D), as local_attention_fwd.cu takes
// them), window 0's previous keys are real: the row pass sweeps keys
// -w .. a from max -inf and denominator 0, so the statistics see the halo
// keys and dq includes them. Neither key pass forms a gradient for the
// halo (pallas_attention.py:570-574, :704-707): that comes from one
// recompute of window 0 outside the kernels (halo_grads in
// ops/cuda_attention.py, _halo_grads there).
//
// float32 layout of the work: the head dim is cut into slices of
// DS = min(D, 32) values and TPR = D / DS neighbouring threads share one
// row (or one key, in the key passes), each holding its slice in
// registers; a dot product is a DS-long fmaf chain per thread plus a
// butterfly over the TPR lanes. Key (row) tiles of 32 are staged in
// shared memory as float32 by plain loads, one tile at a time. Every pass
// computes s and dp with the same code (split_dot), so the probabilities
// the key passes recompute are bit-equal to the ones the statistics were
// taken over. Products and sums, p and ds included, run in float32 on the
// FMA units (67 TFLOP/s on an H100, against 989 for bfloat16 on the
// tensor cores): this path is bound by operations, far from the
// function's bound, and is kept because the tensor cores cannot give
// float32's accuracy (TF32 keeps about 3 digits), which the float32 model
// and its 1e-4 card tolerance need.
#pragma once

#include "common.cuh"

namespace progen_attn_bwd {

constexpr int NT = 128;  // threads per block, every pass
constexpr int TK = 32;   // keys per shared-memory tile (row pass)
constexpr int TR = 32;   // query rows per shared-memory tile (key passes)
constexpr int CH = 8;    // keys per online-softmax rescale

template <int D>
struct Split {
  static constexpr int DS = D < 32 ? D : 32;  // head-dim slice per thread
  static constexpr int TPR = D / DS;          // threads per row or key
  static constexpr int ROWS = NT / TPR;       // rows or keys per block
};

// Sum over the TPR neighbouring lanes that share one row or key; every
// lane of the group ends with the same value, whichever lane it is.
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a . b over one DS-long slice, both float4-aligned (b in shared memory
// or registers), then summed over the lane group.
template <int DS, int TPR>
__device__ __forceinline__ float split_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < DS; e += 4) {
    const float4 b4 = *reinterpret_cast<const float4*>(b + e);
    acc = fmaf(a[e + 0], b4.x, acc);
    acc = fmaf(a[e + 1], b4.y, acc);
    acc = fmaf(a[e + 2], b4.z, acc);
    acc = fmaf(a[e + 3], b4.w, acc);
  }
  return group_sum<TPR>(acc);
}

// Stage rows [r0, r0 + R) of a (n, D) slab as float32 into dst[R][D];
// rows at or past `end` read as zero. With HALO, rows -w .. -1 come from
// the (w, D) halo slab (only key rows of window 0 are ever negative).
template <typename T, int R, int D, bool HALO = false>
__device__ __forceinline__ void stage_rows(float (*dst)[D],
                                           const T* __restrict__ src,
                                           int r0, int end,
                                           const T* __restrict__ halo =
                                               nullptr,
                                           int w = 0) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int rr = idx / D;
    const int c = idx - rr * D;
    const int r = r0 + rr;
    if (HALO && r < 0)
      dst[rr][c] = progen::to_f32(halo[(size_t)(r + w) * D + c]);
    else
      dst[rr][c] = r < end ? progen::to_f32(src[(size_t)r * D + c]) : 0.f;
  }
}

// Row pass: grid (ceil(w / ROWS), n / w, bh), NT threads. For each query
// row: sweep 1 over its visible keys takes the online softmax statistics
// (m, l) and t = sum e * dp, so delta = t / l; sweep 2 recomputes p and
// ds and accumulates dq. Writes dq in T and stats[row] = {m, l, delta, 0}.
// HALO: hk, hv are window 0's previous keys and values; without it they
// are unused and window 0 sees the phantom zeros.
template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(NT)
    rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ hk,
                const T* __restrict__ hv, const T* __restrict__ dout,
                T* __restrict__ dq, float4* __restrict__ stats, int n, int w,
                float scale) {
  using S = Split<D>;
  constexpr int DS = S::DS, TPR = S::TPR, ROWS = S::ROWS;
  __shared__ __align__(16) float ks[TK][D];
  __shared__ __align__(16) float vs[TK][D];

  const int bh = blockIdx.z;
  const int win = blockIdx.y;
  const int a0 = blockIdx.x * ROWS;
  const int sub = threadIdx.x % TPR;
  const int a = a0 + threadIdx.x / TPR;  // row within the window
  const bool active = a < w;
  const int row = win * w + a;
  const int c0 = sub * DS;
  const size_t base = (size_t)bh * n * D;

  float qr[DS], dr[DS];
#pragma unroll
  for (int e = 0; e < DS; ++e) {
    qr[e] = active ? progen::to_f32(q[base + (size_t)row * D + c0 + e]) : 0.f;
    dr[e] =
        active ? progen::to_f32(dout[base + (size_t)row * D + c0 + e]) : 0.f;
  }

  const bool phantom = !HALO && win == 0;
  const T* hkb = HALO ? hk + (size_t)bh * w * D : nullptr;
  const T* hvb = HALO ? hv + (size_t)bh * w * D : nullptr;
  const int kbeg = phantom ? 0 : (win - 1) * w;
  const int kend = win * w + min(a0 + ROWS, w);  // exclusive

  // sweep 1: statistics. Window 0 without a halo starts with its w
  // phantom keys seen.
  float m = phantom ? 0.f : -INFINITY;
  float l = phantom ? (float)w : 0.f;
  float t = 0.f;
  for (int t0 = kbeg; t0 < kend; t0 += TK) {
    stage_rows<T, TK, D, HALO>(ks, k + base, t0, kend, hkb, w);
    stage_rows<T, TK, D, HALO>(vs, v + base, t0, kend, hvb, w);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < TK; j0 += CH) {
      float s[CH], dp[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int j = t0 + j0 + c;
        const float dot = split_dot<DS, TPR>(qr, &ks[j0 + c][c0]);
        dp[c] = split_dot<DS, TPR>(dr, &vs[j0 + c][c0]);
        s[c] = (j < kend && j <= row) ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      // nothing visible yet: keep every term 0 rather than exp(nan)
      const float ms = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m - ms);
      l *= corr;
      t *= corr;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float e = expf(s[c] - ms);
        l += e;
        t = fmaf(e, dp[c], t);
      }
      m = m_new;
    }
    __syncthreads();
  }
  const float delta = t / l;

  // sweep 2: dq
  float acc[DS];
#pragma unroll
  for (int e = 0; e < DS; ++e) acc[e] = 0.f;
  for (int t0 = kbeg; t0 < kend; t0 += TK) {
    stage_rows<T, TK, D, HALO>(ks, k + base, t0, kend, hkb, w);
    stage_rows<T, TK, D, HALO>(vs, v + base, t0, kend, hvb, w);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < TK; ++c) {
      const int j = t0 + c;
      const float s = split_dot<DS, TPR>(qr, &ks[c][c0]) * scale;
      const float dp = split_dot<DS, TPR>(dr, &vs[c][c0]);
      const float p = (j < kend && j <= row) ? expf(s - m) / l : 0.f;
      const float ds = p * (dp - delta);
      const float4* kr = reinterpret_cast<const float4*>(&ks[c][c0]);
#pragma unroll
      for (int e = 0; e < DS / 4; ++e) {
        const float4 k4 = kr[e];
        acc[4 * e + 0] = fmaf(ds, k4.x, acc[4 * e + 0]);
        acc[4 * e + 1] = fmaf(ds, k4.y, acc[4 * e + 1]);
        acc[4 * e + 2] = fmaf(ds, k4.z, acc[4 * e + 2]);
        acc[4 * e + 3] = fmaf(ds, k4.w, acc[4 * e + 3]);
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int e = 0; e < DS; ++e)
      dq[base + (size_t)row * D + c0 + e] = progen::from_f32<T>(acc[e] * scale);
    if (sub == 0) stats[(size_t)bh * n + row] = make_float4(m, l, delta, 0.f);
  }
}

// One key's share of the key passes: the thread's slices of k_c and v_c
// are in kr, vr; the row tile and its statistics are in shared memory.
// Accumulates dk (without the scale) and dv over rows [0, rows) of the
// tile for which visible(row) holds.
template <int DS, int TPR, typename Visible>
__device__ __forceinline__ void key_rows(float (*qs)[DS * TPR],
                                         float (*dos)[DS * TPR],
                                         const float4* st, int rows, int c0,
                                         float scale, const float* kr,
                                         const float* vr, float* dk,
                                         float* dv, Visible visible) {
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const float s = split_dot<DS, TPR>(kr, &qs[r][c0]) * scale;
    const float dp = split_dot<DS, TPR>(vr, &dos[r][c0]);
    const float4 sr = st[r];  // {m, l, delta, -}
    const float p = visible(r) ? expf(s - sr.x) / sr.y : 0.f;
    const float g = p * (dp - sr.z);
    const float4* q4 = reinterpret_cast<const float4*>(&qs[r][c0]);
    const float4* d4 = reinterpret_cast<const float4*>(&dos[r][c0]);
#pragma unroll
    for (int e = 0; e < DS / 4; ++e) {
      const float4 qv = q4[e];
      const float4 dv4 = d4[e];
      dk[4 * e + 0] = fmaf(g, qv.x, dk[4 * e + 0]);
      dk[4 * e + 1] = fmaf(g, qv.y, dk[4 * e + 1]);
      dk[4 * e + 2] = fmaf(g, qv.z, dk[4 * e + 2]);
      dk[4 * e + 3] = fmaf(g, qv.w, dk[4 * e + 3]);
      dv[4 * e + 0] = fmaf(p, dv4.x, dv[4 * e + 0]);
      dv[4 * e + 1] = fmaf(p, dv4.y, dv[4 * e + 1]);
      dv[4 * e + 2] = fmaf(p, dv4.z, dv[4 * e + 2]);
      dv[4 * e + 3] = fmaf(p, dv4.w, dv[4 * e + 3]);
    }
  }
}

// Stage the statistics of rows [r0, r0 + TR) (rows past `end` get l = 1
// so an unused slot never divides by zero).
__device__ __forceinline__ void stage_stats(float4* dst,
                                            const float4* __restrict__ src,
                                            int r0, int end) {
  for (int rr = threadIdx.x; rr < TR; rr += NT) {
    const int r = r0 + rr;
    dst[rr] = r < end ? src[r] : make_float4(0.f, 1.f, 0.f, 0.f);
  }
}

}  // namespace progen_attn_bwd
