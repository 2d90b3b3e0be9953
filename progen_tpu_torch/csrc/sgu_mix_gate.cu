// Fused spatial-gating-unit tail: norm(gate) -> causal mix -> x * gate.
//
// Replaces: progen_tpu/ops/pallas_layers.py:_sgu_pallas (kernel body
// _sgu_kernel). Same function, for x and gate of shape (B, n, d), W (n, n)
// float32, bias (n, 1) float32, scale (d,) float32:
//   g[j, c]   = round_T((gate[j, c] - mean_j) * (rstd_j * scale[c]))
//   mix[m, c] = sum_{j <= m} W[m, j] * g[j, c]          (float32)
//   out[m, c] = round_T(x[m, c] * round_T(mix[m, c] + bias[m]))
// The gate is normalised and rounded to the output dtype BEFORE the mix,
// as the unfused path does, so results agree in bfloat16 too.
//
// What bounds it on this card: operations. The causal product is
// B * d * n(n+1)/2 multiply-adds (17.2 GFLOP at the base shapes, B = 8,
// n = 1024, d = 2048) against 3 * B * n * d bytes of x, gate and output
// plus W: far above the balance. W is float32, so exact parity keeps the
// product on the float32 FMA units (no bfloat16 tensor cores; TF32 would
// change the result).
//
// Design: two launches from one call. sgu_gate_stats: one warp per gate
// row computes the row's mean and rstd (the TPU kernel recomputes them
// for every (i, j) tile; here they are computed once, 8 bytes a row).
// sgu_mix_kernel: a classic register-tiled SGEMM. Each block owns a
// 64 x 64 (rows m, channels c) output tile and walks the reduction over j
// in tiles of 16 inside the block (the TPU grid carried the sum across
// grid steps; blocks here carry nothing between them). It normalises and
// rounds each gate tile as it stages it in shared memory, zeroes W above
// the diagonal in the diagonal tile, and never visits tiles with j > m:
// the structural zeros of the causal mix are skipped. Each thread keeps a
// 4 x 4 float32 accumulator; the epilogue adds the bias, rounds, and
// multiplies into x.
//
// Sequence shards: the TPU path shards the weight's output rows over the
// seq axis (partition.py's sgu_seq_out rule). A shard computes output rows
// [row0, row0 + rows) against the whole gate: x, out and the weights' and
// biases' rows are the shard's, the gate and its statistics span all n
// positions. Every output element still sums j = 0, 1, ... in the same
// order (the zero weights above the diagonal add exact zeros), so a
// sharded mix is bit-equal to the whole one. row0 = 0, rows = n is the
// unsharded call.
#include "common.cuh"

namespace {

constexpr int BM = 64;  // output rows m per block
constexpr int BN = 64;  // channels c per block
constexpr int BK = 16;  // reduction (j) tile
constexpr int THREADS = 256;
constexpr int STATS_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(STATS_WARPS * 32)
    sgu_gate_stats(const T* __restrict__ gate, float2* __restrict__ stats,
                   int rows, int d, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * STATS_WARPS + warp;
  if (r >= rows) return;
  const T* gr = gate + (size_t)r * d;
  float s = 0.f, ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float g = progen::to_f32(gr[c]);
    s += g;
    ss += g * g;
  }
  s = progen::warp_sum(s);
  ss = progen::warp_sum(ss);
  if (lane == 0) {
    float mu, rstd;
    progen::norm_stats(s, ss, d, eps, &mu, &rstd);
    stats[r] = make_float2(mu, rstd);
  }
}

// SHARD: output rows [row0, row0 + rows); without it row0 = 0 and
// rows = n are compile-time facts, and the kernel is the unsharded one.
template <typename T, bool SHARD>
__global__ void __launch_bounds__(THREADS)
    sgu_mix_kernel(const T* __restrict__ x, const T* __restrict__ gate,
                   const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale,
                   const float2* __restrict__ stats, T* __restrict__ out,
                   int n, int shard_row0, int shard_rows, int d) {
  const int row0 = SHARD ? shard_row0 : 0;
  const int rows = SHARD ? shard_rows : n;
  __shared__ __align__(16) float ws[BK][BM + 4];  // W tile, transposed
  __shared__ __align__(16) float gs[BK][BN];      // normalised gate tile

  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;  // the shard's rows; row0 + m0 globally
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // 4 output rows each
  const int tx = tid % 16;  // 4 output channels each
  const size_t bbase = (size_t)b * n * d;     // gate
  const size_t xbase = (size_t)b * rows * d;  // x and out
  const float2* bstats = stats + (size_t)b * n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  const int kend = min(row0 + m0 + BM, n);  // j <= row0 + m < row0 + m0 + BM
  for (int k0 = 0; k0 < kend; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int mi = e / BK;
      const int ki = e % BK;
      const int m = m0 + mi;
      const int j = k0 + ki;
      ws[ki][mi] = (m < rows && j < n && j <= row0 + m)
                       ? w[(size_t)m * n + j]
                       : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int ki = e / BN;
      const int ci = e % BN;
      const int j = k0 + ki;
      const int c = c0 + ci;
      float g = 0.f;
      if (j < n && c < d) {
        const float2 st = bstats[j];
        g = progen::round_to<T>(
            (progen::to_f32(gate[bbase + (size_t)j * d + c]) - st.x) *
            (st.y * scale[c]));
      }
      gs[ki][ci] = g;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[kk][ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&gs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], gv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= rows) continue;
    const float bm = bias[m];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tx * 4 + jj;
      if (c >= d) continue;
      const size_t idx = xbase + (size_t)m * d + c;
      const float g = progen::round_to<T>(acc[i][jj] + bm);
      out[idx] = progen::from_f32<T>(progen::to_f32(x[idx]) * g);
    }
  }
}

template <typename T>
int launch(const void* x, const void* gate, const void* w, const void* bias,
           const void* scale, void* out, void* stats, int batch, int n,
           int row0, int rows, int d, float eps, cudaStream_t stream) {
  const int gate_rows = batch * n;
  sgu_gate_stats<T><<<(gate_rows + STATS_WARPS - 1) / STATS_WARPS,
                      STATS_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(gate), static_cast<float2*>(stats), gate_rows,
      d, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((d + BN - 1) / BN, (rows + BM - 1) / BM, batch);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gate);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(bias);
  const float* st = static_cast<const float*>(scale);
  const float2* stt = static_cast<const float2*>(stats);
  T* ot = static_cast<T*>(out);
  if (row0 == 0 && rows == n)
    sgu_mix_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        xt, gt, wt, bt, st, stt, ot, n, row0, rows, d);
  else
    sgu_mix_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        xt, gt, wt, bt, st, stt, ot, n, row0, rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// gate: (batch, n, d) contiguous; x, out: (batch, rows, d), the output
// rows [row0, row0 + rows), in the gate's dtype; weights (rows, n) and
// biases (rows,) float32, those rows of the (n, n) and (n,) parameters;
// scale (d,) float32; stats: scratch of batch * n float2.
extern "C" int sgu_mix_gate(const void* x, const void* gate,
                            const void* weights, const void* biases,
                            const void* scale, void* out, void* stats,
                            int batch, int n, int row0, int rows, int d,
                            float eps, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || batch > 65535 || rows <= 0 ||
      row0 < 0 || row0 + rows > n || (rows + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype,
                        return launch<T>(x, gate, weights, biases, scale,
                                         out, stats, batch, n, row0, rows, d,
                                         eps, s));
  return (int)cudaErrorInvalidValue;
}
