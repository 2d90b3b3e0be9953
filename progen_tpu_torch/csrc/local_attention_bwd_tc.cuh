// Tensor-core passes of the local-attention backward, for the bfloat16
// and float16 instantiations of local_attention_bwd_kv.cu (A2) and
// local_attention_bwd_halo.cu (A3): the row pass both launch first, and
// the per-tile step of their key passes. float32 keeps the FMA kernels of
// local_attention_bwd.cuh. The primitives (cp.async, ldmatrix, mma.sync,
// the padded stride, acc_product) are attention_tc.cuh's, shared with the
// forward.
//
// Each warp owns 16 query rows (row pass) or 16 keys (key passes) and
// forms 16 x 64 tiles of S = Q K^T and dP = dO V^T (key passes: S^T = K
// Q^T and dP^T = V dO^T) against 64-key (64-row) tiles in shared memory.
// The float32 results then pass as the A operand of the next product
// (dQ += dS K, dV += P^T dO, dK += dS^T Q) straight from registers. That
// packing is the one numerical departure from the TPU kernel: P and dS
// are rounded to T before the three products that take them
// (pallas_attention.py keeps them in float32). S and dP are exact
// products of T values summed in float32, so the softmax statistics are
// as exact as the FMA kernels'.
//
// Operands whose reduction runs along the head dim (Q, K, V, dO in S and
// dP) are read by plain ldmatrix; those whose reduction runs along the
// rows (K in dQ, Q and dO in dK and dV) by .trans. Tiles are
// double-buffered: tile i + 1 is in flight while tile i is used. The
// statistics of the row pass are {m, 1 / l, delta, 0} with m in base-2
// units (scores are scaled by scale * log2(e) and exponentiated with
// exp2f), unlike the FMA kernels' {m, l, delta, 0}; each dtype's row pass
// feeds its own key pass.
#pragma once

#include "attention_tc.cuh"

namespace progen_attn_tc {

template <int D>
struct Shape {
  static constexpr int LD = Padded<D>::LD;      // shared row stride
  static constexpr int RT = D <= 64 ? 64 : 32;  // rows per key-pass tile
  // row pass: Q, dO, and two buffers each of K and V
  static constexpr int ROWS_SMEM = 6 * TILE * LD * 2;
  // key pass: K, V, two buffers each of Q, dO and the row statistics
  static constexpr int KEYS_SMEM = (2 * TILE + 4 * RT) * LD * 2 + 2 * RT * 16;
};

// The statistics of rows [r0, r0 + R); rows at or past `hi` are zeros.
template <int R>
__device__ __forceinline__ void load_stats(float4* dst,
                                           const float4* __restrict__ src,
                                           int r0, int hi) {
  for (int rr = threadIdx.x; rr < R; rr += THREADS) {
    const bool ok = r0 + rr < hi;
    cp_async16(dst + rr, ok ? src + r0 + rr : src, ok ? 16 : 0);
  }
}

// x = A1 B1^T and y = A2 B2^T for one warp: A1, A2 are the warp's 16 rows
// at a1, a2 and B1, B2 the N rows at b1, b2 (all [.][LD] in shared
// memory), reduced over the D columns. x, y: [N / 8][4] accumulators
// (n-tile j, element e: row g + 8 (e / 2), column 8 j + 2 t + e % 2 with
// g = lane / 4, t = lane % 4), overwritten.
template <typename T, int D, int N>
__device__ __forceinline__ void two_products(const T* a1, const T* b1,
                                             const T* a2, const T* b2,
                                             float (*x)[4], float (*y)[4],
                                             int lane) {
  constexpr int LD = Shape<D>::LD;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
  const int ar = (lane % 8) + ((lane / 8) & 1) * 8, ac = (lane / 16) * 8;
  const int br = (lane / 16) * 8 + lane % 8, bc = ((lane / 8) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa1[4], fa2[4];
    ldsm_x4(fa1, a1 + ar * LD + ac + 16 * kk);
    ldsm_x4(fa2, a2 + ar * LD + ac + 16 * kk);
#pragma unroll
    for (int p = 0; p < N / 16; ++p) {
      uint32_t fb[4];
      ldsm_x4(fb, b1 + (16 * p + br) * LD + bc + 16 * kk);
      Mma<T>::run(x[2 * p], fa1, fb[0], fb[1]);
      Mma<T>::run(x[2 * p + 1], fa1, fb[2], fb[3]);
      ldsm_x4(fb, b2 + (16 * p + br) * LD + bc + 16 * kk);
      Mma<T>::run(y[2 * p], fa2, fb[0], fb[1]);
      Mma<T>::run(y[2 * p + 1], fa2, fb[2], fb[3]);
    }
  }
}

// Row pass on tensor cores: grid (ceil(w / TILE), n / w, bh), THREADS
// threads, Shape<D>::ROWS_SMEM bytes of dynamic shared memory. Block (x, i)
// owns rows a0 = TILE x .. of window i; warp r of it rows a0 + 16 r ... The
// keys are walked in two ranges, each cut into TILE-key tiles from its own
// start: the previous window [(i-1) w, i w) (skipped with the phantom start;
// from the halo for window 0 with HALO) and the window's own keys up to the
// block's last row. Aligning the tiles to the window start, not to the
// sequence, makes window 0 with a halo walk the same tiles in the same order
// as the window after it on the whole sequence, so its dq is bit-equal (a
// zero halo also leaves (m, l, t) where the phantom start puts them: score
// 0, exactly w ones summed, t = 0). A warp skips the products of a tile that
// starts past its last row (every score masked: the update would leave (m,
// l, t) bit for bit as they are). Sweep 1 takes (m, l, t) per row, sweep 2
// recomputes S and dP with the same instructions, forms P and dS in float32
// and accumulates dq.
template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(THREADS)
    rows_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ hk,
                   const T* __restrict__ hv, const T* __restrict__ dout,
                   T* __restrict__ dq, float4* __restrict__ stats, int n,
                   int w, float scale) {
  constexpr int LD = Shape<D>::LD, NK = TILE / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + TILE * LD;
  T* ks = dos + TILE * LD;  // [2][TILE][LD]
  T* vs = ks + 2 * TILE * LD;

  const int bh = blockIdx.z, win = blockIdx.y, a0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const size_t base = (size_t)bh * n * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* hkb = HALO ? hk + (size_t)bh * w * D : nullptr;
  const T* hvb = HALO ? hv + (size_t)bh * w * D : nullptr;
  const int w0 = win * w;  // the window's first row
  const int kend = w0 + min(a0 + TILE, w);
  const bool phantom = !HALO && win == 0;
  const int n0 = phantom ? 0 : (w + TILE - 1) / TILE;
  const int ntiles = n0 + (kend - w0 + TILE - 1) / TILE;
  auto tile_start = [&](int i) {
    return i < n0 ? w0 - w + i * TILE : w0 + (i - n0) * TILE;
  };
  auto tile_end = [&](int i) { return i < n0 ? w0 : kend; };
  auto load_kv = [&](int i) {
    T* kd = ks + (i & 1) * TILE * LD;
    T* vd = vs + (i & 1) * TILE * LD;
    load_rows<T, TILE, D, HALO>(kd, kb, hkb, tile_start(i), tile_end(i), w);
    load_rows<T, TILE, D, HALO>(vd, vb, hvb, tile_start(i), tile_end(i), w);
    cp_async_commit();
  };

  const int wr0 = a0 + 16 * warp;  // the warp's first row in the window
  const bool live = wr0 < w;
  const int last_row = w0 + wr0 + 15;
  const int rows[2] = {w0 + wr0 + g, w0 + wr0 + g + 8};
  const float c = scale * LOG2E;
  const T* qw = qs + 16 * warp * LD;
  const T* dow = dos + 16 * warp * LD;

  float m[2], l[2], t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = phantom ? 0.f : -INFINITY;
    l[h] = phantom ? (float)w : 0.f;
    t[h] = 0.f;
  }
  float s[NK][4], dp[NK][4];

  // sweep 1: statistics
  load_rows<T, TILE, D, false>(qs, q + base, nullptr, w0 + a0, w0 + w, w);
  load_rows<T, TILE, D, false>(dos, dout + base, nullptr, w0 + a0, w0 + w,
                               w);
  load_kv(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = tile_start(i), end = tile_end(i);
    if (live && t0 <= last_row) {
      two_products<T, D, TILE>(qw, ks + (i & 1) * TILE * LD, dow,
                               vs + (i & 1) * TILE * LD, s, dp, lane);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * tq + (e & 1);
          const bool vis = key < end && key <= rows[e / 2];
          s[j][e] = vis ? s[j][e] * c : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float ms[2], ls[2] = {0.f, 0.f}, ts[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // nothing visible yet: keep every term 0 rather than exp(nan)
        ms[h] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[h] - ms[h]);
        l[h] *= corr;
        t[h] *= corr;
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ev = exp2f(s[j][e] - ms[e / 2]);
          ls[e / 2] += ev;
          ts[e / 2] = fmaf(ev, dp[j][e], ts[e / 2]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the 4 lanes of a row end with one value, bit for bit
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
        ts[h] += __shfl_xor_sync(0xffffffffu, ts[h], 1);
        ts[h] += __shfl_xor_sync(0xffffffffu, ts[h], 2);
        l[h] += ls[h];
        t[h] += ts[h];
      }
    }
    __syncthreads();
  }
  float rl[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = 1.f / l[h];
    delta[h] = t[h] / l[h];
  }

  // sweep 2: dq
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  load_kv(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = tile_start(i), end = tile_end(i);
    if (live && t0 <= last_row) {
      two_products<T, D, TILE>(qw, ks + (i & 1) * TILE * LD, dow,
                               vs + (i & 1) * TILE * LD, s, dp, lane);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const int key = t0 + 8 * j + 2 * tq + (e & 1);
          const bool vis = key < end && key <= rows[h];
          const float p = vis ? exp2f(s[j][e] * c - m[h]) * rl[h] : 0.f;
          s[j][e] = p * (dp[j][e] - delta[h]);  // ds
        }
      acc_product<T, D, TILE>(s, ks + (i & 1) * TILE * LD, acc, lane);
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= w0 + w) continue;
    T* out = dq + base + (size_t)row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store2<T>(out + 8 * j, acc[j][2 * h] * scale,
                acc[j][2 * h + 1] * scale);
    if (tq == 0)
      stats[(size_t)bh * n + row] = make_float4(m[h], rl[h], delta[h], 0.f);
  }
}

// One row tile of a key pass for one warp: its 16 keys (K, V rows at kw,
// vw; the thread's keys key0 and key0 + 8) against the RT rows at qs, dos
// with their statistics st, rows r0 .. r0 + RT - 1 of which those below
// rend that are at or past a key see it. Accumulates dk (without the
// scale) and dv.
template <typename T, int D>
__device__ __forceinline__ void key_tile(const T* kw, const T* vw,
                                         const T* qs, const T* dos,
                                         const float4* st, int r0, int rend,
                                         int key0, float c, float (*dk)[4],
                                         float (*dv)[4], int lane) {
  constexpr int RT = Shape<D>::RT, NR = RT / 8;
  const int tq = lane % 4;
  float s[NR][4], dp[NR][4];
  two_products<T, D, RT>(kw, qs, vw, dos, s, dp, lane);
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = 8 * j + 2 * tq + (e & 1);
      const int row = r0 + rr;
      const float4 sr = st[rr];  // {m, 1 / l, delta, 0}
      const bool vis = row < rend && row >= key0 + 8 * (e / 2);
      const float p = vis ? exp2f(s[j][e] * c - sr.x) * sr.y : 0.f;
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - sr.z);  // ds
    }
  acc_product<T, D, RT>(s, dos, dv, lane);
  acc_product<T, D, RT>(dp, qs, dk, lane);
}

// Launch rows_tc_kernel (with or without a halo) on its grid.
template <typename T, int D>
int launch_rows(const T* q, const T* k, const T* v, const T* hk, const T* hv,
                const T* dout, T* dq, float4* stats, int bh, int n, int w,
                float scale, cudaStream_t stream) {
  constexpr int smem = Shape<D>::ROWS_SMEM;
  const dim3 grid((w + TILE - 1) / TILE, n / w, bh);
  auto kernel = hk != nullptr ? rows_tc_kernel<T, D, true>
                              : rows_tc_kernel<T, D, false>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, hk, hv, dout, dq, stats,
                                          n, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace progen_attn_tc
