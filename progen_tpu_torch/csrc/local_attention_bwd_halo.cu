// Windowed causal local-attention backward, q-centric with a halo (A3).
//
// Replaces: progen_tpu/ops/pallas_attention.py:_bwd_core, halo branch
// (call at :683, kernel body _bwd_kernel). Same function: program i gives
// dq_i from its own softmax row and float32 gradients dk2, dv2 for all 2w
// keys of its [prev | cur] pair, into a (bh, n / w, 2w, d) float32
// scratch. The overlap is resolved outside the kernel, as the TPU path
// does in XLA (`combine`, pallas_attention.py:704-710, here
// ops/cuda_attention.py:_halo_combine): window i's dk is program i's
// current half plus program i+1's previous half, and program 0's previous
// half (the gradient of the phantom zero keys) is dropped. dq is written
// in the input dtype; every product and sum is float32.
//
// What bounds it on this card: the TPU cost estimate counts 5 products of
// 2 * bh * n * 2w * d operations (43 GFLOP at bh = 64, n = 1024, w = 512,
// d = 64) against q, k, v, dO, dq, dk and dv in bfloat16 (59 MB) plus
// the two float32 scratches written once (67 MB): operations bound it at
// the tensor cores' bfloat16 rate (0.043 ms, against 0.038 ms for bytes).
// This
// simple version computes on the float32 FMA units (67 TFLOP/s, 0.64 ms
// for the same count), so it is bound by operations, far from that bound.
//
// Design: the TPU kernel holds the (w, 2w) float32 probability block of
// its window in VMEM (2 MB at w = 512); a Hopper block cannot. Two
// launches here, neither storing a probability block:
//  1. the row pass of local_attention_bwd.cuh: per query row the softmax
//     statistics (max, denominator, delta = sum p * dp) into a (bh, n)
//     float32 scratch, and dq_i;
//  2. halo_kernel: TPR threads per key of the pair [window i-1 | window i]
//     hold its k and v slices (zeros for window 0's phantom keys, which
//     still have score 0 and a probability) and its float32 dk2, dv2
//     accumulators in registers; the rows of window i that see the block's
//     keys (row a sees key c when c <= a + w) stream through shared memory
//     with their statistics, and each key recomputes p and ds row by row.
//
// With a halo (A4, the halo branch of pallas_local_attention_halo's
// backward): the row pass takes window 0's previous keys from hk, hv, and
// program 0's key pass holds the halo keys in place of the phantom zeros,
// so its previous half of the scratch is the halo's own gradient. The
// combine still drops it, as the TPU path does: the halo's gradient comes
// from halo_grads (ops/cuda_attention.py), the counterpart of _halo_grads.
#include "local_attention_bwd.cuh"

namespace {

using namespace progen_attn_bwd;

template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(NT)
    halo_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ hk,
                const T* __restrict__ hv, const T* __restrict__ dout,
                const float4* __restrict__ stats, float* __restrict__ dk2,
                float* __restrict__ dv2, int n, int w, float scale) {
  using S = Split<D>;
  constexpr int DS = S::DS, TPR = S::TPR, ROWS = S::ROWS;
  __shared__ __align__(16) float qs[TR][D];
  __shared__ __align__(16) float dos[TR][D];
  __shared__ float4 st[TR];

  const int nw = n / w;
  const int bh = blockIdx.z;
  const int win = blockIdx.y;  // i
  const int cb = blockIdx.x * ROWS;
  const int sub = threadIdx.x % TPR;
  const int c = cb + threadIdx.x / TPR;  // key within the 2w pair
  const bool active = c < 2 * w;
  const int key = (win - 1) * w + c;      // its sequence position
  const bool phantom = key < 0;           // window 0's previous half
  const int c0 = sub * DS;
  const size_t base = (size_t)bh * n * D;
  const size_t hbase = (size_t)bh * w * D;

  float kr[DS], vr[DS], dka[DS], dva[DS];
#pragma unroll
  for (int e = 0; e < DS; ++e) {
    if (HALO && active && phantom) {  // the halo in place of the zeros
      kr[e] = progen::to_f32(hk[hbase + (size_t)(key + w) * D + c0 + e]);
      vr[e] = progen::to_f32(hv[hbase + (size_t)(key + w) * D + c0 + e]);
    } else {
      const bool load = active && !phantom;
      kr[e] =
          load ? progen::to_f32(k[base + (size_t)key * D + c0 + e]) : 0.f;
      vr[e] =
          load ? progen::to_f32(v[base + (size_t)key * D + c0 + e]) : 0.f;
    }
    dka[e] = 0.f;
    dva[e] = 0.f;
  }

  // rows a of window i with a + w >= the block's first key
  const int rbeg = win * w + max(0, cb - w);
  const int rend = (win + 1) * w;  // exclusive
  for (int r0 = rbeg; r0 < rend; r0 += TR) {
    stage_rows<T, TR, D>(qs, q + base, r0, rend);
    stage_rows<T, TR, D>(dos, dout + base, r0, rend);
    stage_stats(st, stats + (size_t)bh * n, r0, rend);
    __syncthreads();
    const int rows = min(TR, rend - r0);
    const int a0 = r0 - win * w;
    key_rows<DS, TPR>(qs, dos, st, rows, c0, scale, kr, vr, dka, dva,
                      [&](int r) { return c <= a0 + r + w; });
    __syncthreads();
  }

  if (active) {
    const size_t out = (((size_t)bh * nw + win) * 2 * w + c) * D + c0;
#pragma unroll
    for (int e = 0; e < DS; ++e) {
      dk2[out + e] = dka[e] * scale;
      dv2[out + e] = dva[e];
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, const void* dout, void* dq, void* dk2, void* dv2,
           void* stats, int bh, int n, int w, float scale,
           cudaStream_t stream) {
  using S = Split<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* hkt = static_cast<const T*>(hk);
  const T* hvt = static_cast<const T*>(hv);
  const T* dt = static_cast<const T*>(dout);
  float4* st = static_cast<float4*>(stats);
  T* dqt = static_cast<T*>(dq);
  float* dk2t = static_cast<float*>(dk2);
  float* dv2t = static_cast<float*>(dv2);
  const dim3 rows_grid((w + S::ROWS - 1) / S::ROWS, n / w, bh);
  const dim3 halo_grid((2 * w + S::ROWS - 1) / S::ROWS, n / w, bh);
  if (hk != nullptr) {
    rows_kernel<T, D, true><<<rows_grid, NT, 0, stream>>>(
        qt, kt, vt, hkt, hvt, dt, dqt, st, n, w, scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    halo_kernel<T, D, true><<<halo_grid, NT, 0, stream>>>(
        qt, kt, vt, hkt, hvt, dt, st, dk2t, dv2t, n, w, scale);
  } else {
    rows_kernel<T, D, false><<<rows_grid, NT, 0, stream>>>(
        qt, kt, vt, hkt, hvt, dt, dqt, st, n, w, scale);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    halo_kernel<T, D, false><<<halo_grid, NT, 0, stream>>>(
        qt, kt, vt, hkt, hvt, dt, st, dk2t, dv2t, n, w, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* hk,
             const void* hv, const void* dout, void* dq, void* dk2,
             void* dv2, void* stats, int bh, int n, int w, int d, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, hk, hv, dout, dq, dk2, dv2, stats, bh, n, w, scale, s);
    case 32: return launch<T, 32>(q, k, v, hk, hv, dout, dq, dk2, dv2, stats, bh, n, w, scale, s);
    case 64: return launch<T, 64>(q, k, v, hk, hv, dout, dq, dk2, dv2, stats, bh, n, w, scale, s);
    case 128: return launch<T, 128>(q, k, v, hk, hv, dout, dq, dk2, dv2, stats, bh, n, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq: (bh, n, d) contiguous, one dtype; dk2, dv2: float32
// (bh, n / w, 2w, d); stats: a float32 (bh, n, 4) scratch. n % w == 0.
// hk, hv: (bh, w, d) halo keys and values in the same dtype, both or
// neither (nullptr: the phantom zeros).
extern "C" int local_attention_bwd_halo(const void* q, const void* k,
                                        const void* v, const void* hk,
                                        const void* hv, const void* dout,
                                        void* dq, void* dk2, void* dv2,
                                        void* stats, int bh, int n, int w,
                                        int d, float scale, int dtype,
                                        void* stream) {
  if (bh <= 0 || w <= 0 || n % w != 0 || bh > 65535 || n / w > 65535 ||
      (hk == nullptr) != (hv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype, return launch_d<T>(q, k, v, hk, hv, dout, dq,
                                                  dk2, dv2, stats, bh, n, w,
                                                  d, scale, s));
  return (int)cudaErrorInvalidValue;
}
