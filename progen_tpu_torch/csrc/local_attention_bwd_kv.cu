// Windowed causal local-attention backward, kv-centric (A2).
//
// Replaces: progen_tpu/ops/pallas_attention.py:_bwd_core, kv branch (call
// at :652, kernel body _bwd_kv_kernel_batched). Same function: program j
// owns k_j and v_j, whose only consumers are the query rows of window j
// (the current half of their [prev | cur] keys: key c seen by rows a >= c)
// and of window j+1 (the previous half: every row sees every key). It
// recomputes both softmax rows and gives dq_j from row j, and dk_j, dv_j
// from row j's current half plus row j+1's previous half, fully combined;
// the last window has no row j+1 (has_next). No gradient is ever formed
// for window 0's phantom keys. dq, dk and dv are written in the input
// dtype; every product and sum is float32.
//
// What bounds it on this card: at the base training shapes (bh = 64,
// n = 1024, w = 512, d = 64, bfloat16) the TPU cost estimate counts 8
// products of 2 * bh * n * 2w * d operations (69 GFLOP) against 7 * bh * n
// * d * 2 bytes (59 MB) of q, k, v, dO, dq, dk and dv: by that count,
// operations bound it at the tensor cores' bfloat16 rate (0.07 ms). This
// simple version computes on the float32 FMA units (67 TFLOP/s, where the
// same count would take 1.0 ms), so it is bound by operations and runs
// far from the tensor-core bound.
//
// Design: the TPU kernel holds two (g, w, 2w) float32 probability blocks
// in VMEM (2 MB each at w = 512), which no Hopper block can. Two launches
// here, neither storing a probability block:
//  1. the row pass of local_attention_bwd.cuh: per query row the softmax
//     statistics (max, denominator, delta = sum p * dp) into a (bh, n)
//     float32 scratch, and dq_j (row j's part of the TPU program);
//  2. kv_kernel: TPR threads per key of window j hold its k and v slices
//     and its float32 dk, dv accumulators in registers; the query rows of
//     window j (from the block's first key on) and, when j + 1 < n / w,
//     all rows of window j+1 stream through shared memory in tiles of TR
//     with their statistics, and each key recomputes p and ds row by row.
// Both kinds of consumer row see key c exactly when row >= key, so one
// visibility test covers the current and the previous half.
//
// With a halo (A4, the kv branch of pallas_local_attention_halo's
// backward): the row pass takes window 0's previous keys from hk, hv, so
// the statistics and dq see them; kv_kernel is unchanged, since it forms
// gradients only for the shard's own keys. The last window's keys also
// feed the right neighbour's window 0: that share arrives through the
// halo's gradient, which the caller adds (ops/cuda_attention.py,
// parallel/collectives.py).
#include "local_attention_bwd.cuh"

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, const void* dout, void* dq, void* dk, void* dv,
           void* stats, int bh, int n, int w, float scale,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype, return launch_d<T>(q, k, v, hk, hv, dout, dq,
                                                  dk, dv, stats, bh, n, w, d,
                                                  scale, s));
  return (int)cudaErrorInvalidValue;
}
