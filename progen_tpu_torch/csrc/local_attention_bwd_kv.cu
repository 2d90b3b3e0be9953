// Windowed causal local-attention backward, kv-centric (A2).
//
// Replaces: progen_tpu/ops/pallas_attention.py:_bwd_core, kv branch (call
// at :652, kernel body _bwd_kv_kernel_batched). Same function: program j
// owns k_j and v_j, whose only consumers are the query rows of window j
// (the current half of their [prev | cur] keys: key c seen by rows a >= c)
// and of window j+1 (the previous half: every row sees every key). It
// recomputes both softmax rows and gives dq_j from row j, and dk_j, dv_j
// from row j's current half plus row j+1's previous half, fully combined,
// with no scratch; the last window has no row j+1 (has_next,
// pallas_attention.py:222). No gradient is ever formed for window 0's
// phantom keys. dq, dk and dv are written in the input dtype.
//
// What bounds it on this card: at the base training shapes (bh = 64,
// n = 1024, w = 512, d = 64, bfloat16) the function needs 5 products (S,
// dP, dQ, dK, dV) of 2 d operations over the 524,800 visible (query, key)
// pairs of a head: 21.5 GFLOP, 0.022 ms at the tensor cores' 989 TFLOP/s,
// against 59 MB of q, k, v, dO, dq, dk, dv (0.018 ms at 3.35 TB/s):
// bound by operations. This kernel computes 9 products (the row pass
// forms S and dP twice, and dQ; the key pass S, dP, dV and dK again),
// 1.8 times the function's count, on the tensor cores.
//
// Design: the TPU kernel holds two (g, w, 2w) float32 probability blocks
// in VMEM (2 MB each at w = 512), which no Hopper block can. Two launches
// here, neither storing a probability block:
//  1. the row pass: per query row the softmax statistics (max,
//     denominator, delta = sum p * dp) into a (bh, n) float32 scratch,
//     and dq_j (row j's part of the TPU program);
//  2. the key pass: a block owns 64 keys of window j, 16 a warp, with
//     their float32 dk, dv accumulators in registers and their k, v rows
//     in shared memory; the query rows of window j (from the block's
//     first key on) and, when j + 1 < n / w, all rows of window j+1
//     stream through shared memory in tiles with their statistics, and
//     each tile gives S^T, dP^T, then P and dS from the statistics, then
//     dV += P^T dO and dK += dS^T Q.
// Both kinds of consumer row see key c exactly when row >= key, so one
// visibility test covers the current and the previous half.
//
// bfloat16 and float16 (local_attention_bwd_tc.cuh): every product on
// the tensor cores (mma.sync m16n8k16, float32 accumulators); row and key
// tiles of 64 (key-pass row tiles of 32 at d = 128, for registers),
// staged by cp.async into padded shared rows, double-buffered; P and dS
// rounded to the input dtype before the products that take them (the
// TPU kernel keeps them in float32), S and dP exact. float32: the FMA
// kernels of local_attention_bwd.cuh and kv_kernel below, unchanged
// (tensor cores cannot give float32's accuracy); the element type
// chooses, no switch does.
//
// With a halo (A4, the kv branch of pallas_local_attention_halo's
// backward): the row pass takes window 0's previous keys from hk, hv, so
// the statistics and dq see them; the key pass is unchanged, since it
// forms gradients only for the shard's own keys. The last window's keys
// also feed the right neighbour's window 0: that share arrives through
// the halo's gradient, which the caller adds (ops/cuda_attention.py,
// parallel/collectives.py).
#include <initializer_list>
#include <type_traits>

#include "local_attention_bwd.cuh"
#include "local_attention_bwd_tc.cuh"

namespace {

using namespace progen_attn_bwd;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float4* __restrict__ stats, T* __restrict__ dk,
              T* __restrict__ dv, int n, int w, float scale) {
  using S = Split<D>;
  constexpr int DS = S::DS, TPR = S::TPR, ROWS = S::ROWS;
  __shared__ __align__(16) float qs[TR][D];
  __shared__ __align__(16) float dos[TR][D];
  __shared__ float4 st[TR];

  const int nw = n / w;
  const int bh = blockIdx.z;
  const int win = blockIdx.y;  // j
  const int cb = blockIdx.x * ROWS;
  const int sub = threadIdx.x % TPR;
  const int c = cb + threadIdx.x / TPR;  // key within window j
  const bool active = c < w;
  const int key = win * w + c;
  const int c0 = sub * DS;
  const size_t base = (size_t)bh * n * D;

  float kr[DS], vr[DS], dka[DS], dva[DS];
#pragma unroll
  for (int e = 0; e < DS; ++e) {
    kr[e] = active ? progen::to_f32(k[base + (size_t)key * D + c0 + e]) : 0.f;
    vr[e] = active ? progen::to_f32(v[base + (size_t)key * D + c0 + e]) : 0.f;
    dka[e] = 0.f;
    dva[e] = 0.f;
  }

  // row j from the block's first key on; row j+1 only if it exists
  const int rbeg = win * w + cb;
  const int rend = (win + 1 < nw ? win + 2 : win + 1) * w;  // exclusive
  for (int r0 = rbeg; r0 < rend; r0 += TR) {
    stage_rows<T, TR, D>(qs, q + base, r0, rend);
    stage_rows<T, TR, D>(dos, dout + base, r0, rend);
    stage_stats(st, stats + (size_t)bh * n, r0, rend);
    __syncthreads();
    const int rows = min(TR, rend - r0);
    key_rows<DS, TPR>(qs, dos, st, rows, c0, scale, kr, vr, dka, dva,
                      [&](int r) { return r0 + r >= key; });
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int e = 0; e < DS; ++e) {
      dk[base + (size_t)key * D + c0 + e] = progen::from_f32<T>(dka[e] * scale);
      dv[base + (size_t)key * D + c0 + e] = progen::from_f32<T>(dva[e]);
    }
  }
}

// Key pass on tensor cores: grid (ceil(w / TILE), n / w, bh), NT threads,
// Shape<D>::KEYS_SMEM bytes of dynamic shared memory. Block (x, j) owns
// keys cb = TILE x .. of window j, warp r of it keys cb + 16 r ...; rows
// from the block's first key to the end of window j + 1 (j when it is
// the last) stream in tiles of RT, the next tile in flight while this
// one is used. A warp skips a tile whose rows all lie before its keys.
template <typename T, int D>
__global__ void __launch_bounds__(progen_attn_tc::THREADS)
    kv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float4* __restrict__ stats, T* __restrict__ dk,
                 T* __restrict__ dv, int n, int w, float scale) {
  using namespace progen_attn_tc;
  constexpr int LD = Shape<D>::LD, RT = Shape<D>::RT, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + TILE * LD;
  T* qs = vs + TILE * LD;    // [2][RT][LD]
  T* dos = qs + 2 * RT * LD;  // [2][RT][LD]
  float4* st = reinterpret_cast<float4*>(dos + 2 * RT * LD);  // [2][RT]

  const int nw = n / w;
  const int bh = blockIdx.z, win = blockIdx.y, cb = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * D;
  const float4* stb = stats + (size_t)bh * n;
  const int key0 = win * w + cb;  // the block's first key
  // row j from the block's first key on; row j+1 only if it exists
  const int rbeg = key0;
  const int rend = (win + 1 < nw ? win + 2 : win + 1) * w;  // exclusive
  const int ntiles = (rend - rbeg + RT - 1) / RT;
  auto load_tile = [&](int i) {
    const int r0 = rbeg + i * RT;
    load_rows<T, RT, D, false>(qs + (i & 1) * RT * LD, q + base, nullptr,
                               r0, rend, w);
    load_rows<T, RT, D, false>(dos + (i & 1) * RT * LD, dout + base,
                               nullptr, r0, rend, w);
    load_stats<RT>(st + (i & 1) * RT, stb, r0, rend);
    cp_async_commit();
  };

  const int wk0 = key0 + 16 * warp;  // the warp's first key
  const bool live = cb + 16 * warp < w;
  const float c = scale * LOG2E;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  load_rows<T, TILE, D, false>(ks, k + base, nullptr, key0, win * w + w, w);
  load_rows<T, TILE, D, false>(vs, v + base, nullptr, key0, win * w + w, w);
  load_tile(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = rbeg + i * RT;
    if (live && r0 + RT > wk0)
      key_tile<T, D>(ks + 16 * warp * LD, vs + 16 * warp * LD,
                     qs + (i & 1) * RT * LD, dos + (i & 1) * RT * LD,
                     st + (i & 1) * RT, r0, rend, wk0 + lane / 4, c, dka,
                     dva, lane);
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = wk0 + lane / 4 + 8 * h;
    if (key >= win * w + w) continue;
    const size_t off = base + (size_t)key * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      store2<T>(dk + off + 8 * j, dka[j][2 * h] * scale,
                dka[j][2 * h + 1] * scale);
      store2<T>(dv + off + 8 * j, dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

template <typename T, int D>
int launch_tc(const T* q, const T* k, const T* v, const T* hk, const T* hv,
              const T* dout, T* dq, T* dk, T* dv, float4* stats, int bh,
              int n, int w, float scale, cudaStream_t stream) {
  using namespace progen_attn_tc;
  int err = launch_rows<T, D>(q, k, v, hk, hv, dout, dq, stats, bh, n, w,
                              scale, stream);
  if (err != 0) return err;
  constexpr int smem = Shape<D>::KEYS_SMEM;
  err = (int)cudaFuncSetAttribute(
      kv_tc_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const dim3 grid((w + TILE - 1) / TILE, n / w, bh);
  kv_tc_kernel<T, D><<<grid, THREADS, smem, stream>>>(q, k, v, dout, stats, dk,
                                                  dv, n, w, scale);
  return (int)cudaGetLastError();
}

// float32: the FMA row pass and kv_kernel.
template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* hk,
               const void* hv, const void* dout, void* dq, void* dk,
               void* dv, void* stats, int bh, int n, int w, float scale,
               cudaStream_t stream) {
  using S = Split<D>;
  const dim3 grid((w + S::ROWS - 1) / S::ROWS, n / w, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  float4* st = static_cast<float4*>(stats);
  const T* hkt = static_cast<const T*>(hk);
  const T* hvt = static_cast<const T*>(hv);
  T* dqt = static_cast<T*>(dq);
  if (hk != nullptr)
    rows_kernel<T, D, true><<<grid, NT, 0, stream>>>(qt, kt, vt, hkt, hvt,
                                                      dt, dqt, st, n, w,
                                                      scale);
  else
    rows_kernel<T, D, false><<<grid, NT, 0, stream>>>(qt, kt, vt, hkt, hvt,
                                                       dt, dqt, st, n, w,
                                                       scale);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  kv_kernel<T, D><<<grid, NT, 0, stream>>>(qt, kt, vt, dt, st,
                                           static_cast<T*>(dk),
                                           static_cast<T*>(dv), n, w, scale);
  return (int)cudaGetLastError();
}

// bfloat16 and float16 on the tensor cores, float32 on the FMA units.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, const void* dout, void* dq, void* dk, void* dv,
           void* stats, int bh, int n, int w, float scale,
           cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_tc<T, D>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(hk),
        static_cast<const T*>(hv), static_cast<const T*>(dout),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float4*>(stats), bh, n, w, scale, stream);
  else
    return launch_fma<T, D>(q, k, v, hk, hv, dout, dq, dk, dv, stats, bh, n,
                            w, scale, stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* hk,
             const void* hv, const void* dout, void* dq, void* dk, void* dv,
             void* stats, int bh, int n, int w, int d, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, hk, hv, dout, dq, dk, dv, stats, bh, n, w, scale, s);
    case 32: return launch<T, 32>(q, k, v, hk, hv, dout, dq, dk, dv, stats, bh, n, w, scale, s);
    case 64: return launch<T, 64>(q, k, v, hk, hv, dout, dq, dk, dv, stats, bh, n, w, scale, s);
    case 128: return launch<T, 128>(q, k, v, hk, hv, dout, dq, dk, dv, stats, bh, n, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, n, d) contiguous, one dtype; stats: a
// float32 (bh, n, 4) scratch. n % w == 0. hk, hv: (bh, w, d) halo keys
// and values in the same dtype, both or neither (nullptr: the phantom
// zeros).
extern "C" int local_attention_bwd_kv(const void* q, const void* k,
                                      const void* v, const void* hk,
                                      const void* hv, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* stats, int bh, int n, int w,
                                      int d, float scale, int dtype,
                                      void* stream) {
  if (bh <= 0 || w <= 0 || n % w != 0 || bh > 65535 || n / w > 65535 ||
      (hk == nullptr) != (hv == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, hk, hv, dout, (const void*)dq,
                        (const void*)dk, (const void*)dv,
                        (const void*)stats})
    if (!progen_attn_tc::aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype, return launch_d<T>(q, k, v, hk, hv, dout, dq,
                                                  dk, dv, stats, bh, n, w, d,
                                                  scale, s));
  return (int)cudaErrorInvalidValue;
}
