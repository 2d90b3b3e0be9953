// Fused scale-only LayerNorm + token shift.
//
// Replaces: progen_tpu/ops/pallas_layers.py:_norm_shift_pallas (kernel
// body _norm_shift_kernel). Same function: every row is normalised with
// float32 statistics (mean, var = max(0, E[x^2] - E[x]^2), the
// rsqrt * scale product formed first); output channel c < d - d/2 of row r
// takes the normalised row r-1 (zero for r = 0 of each sequence), the
// other channels the normalised row r.
//
// What bounds it on this card: bytes. It reads each input row and writes
// each output row once and does about 6 operations per element.
//
// Design: the TPU kernel normalises a (block, d) row tile plus a one-row
// halo. Here one warp owns one output row: it loads its row and the
// previous row into registers (the previous row is read again by its own
// warp, which usually finds it in L2), reduces both rows' sums with warp
// shuffles, and writes the shifted, normalised row once. No shared memory
// and no cross-warp synchronisation; 8 rows per block.
//
// Sequence shards: row 0 of a shard has a previous row, the last pre-norm
// row of the left neighbouring shard. `prev` (batch, d), when given, is
// that row for each sequence; the warp of row 0 normalises it as it
// normalises any previous row, so a sharded pass is bit-equal to the whole
// one. (A copy of the shard with the row prepended would do the same at
// the cost of one more pass over the shard's activations.) prev = nullptr
// keeps row 0's shifted half zero, unchanged.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
    norm_shift_kernel(const T* __restrict__ x, const T* __restrict__ prev,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int rows, int n, int d, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  const bool first = (r % n) == 0;
  const bool has_prev = !first || prev != nullptr;
  const int split = d - d / 2;
  const T* xr = x + (size_t)r * d;
  // the previous row: the row above, or the neighbour shard's last row
  const T* pr = !first ? xr - d : prev ? prev + (size_t)(r / n) * d : xr;

  float cur[VPL], pv[VPL];
  float s = 0.f, ss = 0.f, ps = 0.f, pss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = i * 32 + lane;
    cur[i] = c < d ? progen::to_f32(xr[c]) : 0.f;
    pv[i] = (has_prev && c < d) ? progen::to_f32(pr[c]) : 0.f;
    s += cur[i];
    ss += cur[i] * cur[i];
    ps += pv[i];
    pss += pv[i] * pv[i];
  }
  s = progen::warp_sum(s);
  ss = progen::warp_sum(ss);
  ps = progen::warp_sum(ps);
  pss = progen::warp_sum(pss);
  float mu, rstd, pmu, prstd;
  progen::norm_stats(s, ss, d, eps, &mu, &rstd);
  progen::norm_stats(ps, pss, d, eps, &pmu, &prstd);

  T* orow = out + (size_t)r * d;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = i * 32 + lane;
    if (c >= d) continue;
    const float sc = scale[c];
    float y;
    if (c < split)
      y = has_prev ? (pv[i] - pmu) * (prstd * sc) : 0.f;
    else
      y = (cur[i] - mu) * (rstd * sc);
    orow[c] = progen::from_f32<T>(y);
  }
}

template <typename T, int VPL>
int launch(const void* x, const void* prev, const void* scale, void* out,
           int rows, int n, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  norm_shift_kernel<T, VPL><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev),
      static_cast<const float*>(scale), static_cast<T*>(out), rows, n, d,
      eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* x, const void* prev, const void* scale, void* out,
             int rows, int n, int d, float eps, cudaStream_t s) {
  if (d <= 128) return launch<T, 4>(x, prev, scale, out, rows, n, d, eps, s);
  if (d <= 512)
    return launch<T, 16>(x, prev, scale, out, rows, n, d, eps, s);
  if (d <= 1024)
    return launch<T, 32>(x, prev, scale, out, rows, n, d, eps, s);
  if (d <= 2048)
    return launch<T, 64>(x, prev, scale, out, rows, n, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out: (rows, d) contiguous, rows = batch * n; scale: (d,) float32;
// prev: (rows / n, d) contiguous in x's dtype, each sequence's row before
// its row 0, or nullptr for none.
extern "C" int norm_shift(const void* x, const void* prev, const void* scale,
                          void* out, int rows, int n, int d, float eps,
                          int dtype, void* stream) {
  if (rows <= 0 || n <= 0 || rows % n != 0 || d < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype,
                        return launch_d<T>(x, prev, scale, out, rows, n, d,
                                           eps, s));
  return (int)cudaErrorInvalidValue;
}
