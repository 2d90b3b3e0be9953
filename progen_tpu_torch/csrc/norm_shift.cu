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
// each output row once and does about 7 operations per element: 33.6 MB,
// 0.0100 ms at 3.35 TB/s at the scoring shapes (8 x 1024 rows of 1024
// bfloat16).
//
// Design: a one-read row pass. The TPU kernel normalises a (block, d) row
// tile plus a one-row halo; here one warp owns one INPUT row r. It loads
// the row once into registers, 16 bytes a lane at a time (8 bfloat16 or 4
// float32: at d = 1024 bfloat16, 4 loads a lane; 7 at d = 1792), takes
// the row's float32 sums once with warp shuffles, normalises, and writes
// it twice in part: channels c >= split to out[r] and channels c < split
// to out[r + 1] when row r + 1 is in the same sequence. The warp of row 0
// of a sequence also writes row 0's shifted half: zeros, or the
// normalised previous row (below). So every input byte is read once and
// every output byte written once; no shared memory, no synchronisation
// between warps, 8 rows a block. A width that is not a multiple of the
// vector (or a pointer that is not 16-byte aligned) takes the same pass
// one element a lane at a time; a vector that the split cuts is stored
// element by element.
//
// Sequence shards: row 0 of a shard has a previous row, the last pre-norm
// row of the left neighbouring shard. `prev` (batch, d), when given, is
// that row for each sequence; the warp of row 0 normalises it with the
// same code and lane mapping as any row, so a sharded pass is bit-equal to
// the whole one. prev = nullptr keeps row 0's shifted half zero.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;

// Row xr normalised into v: lane `lane` holds NS chunks of EPS channels,
// chunk i at channels (32 i + lane) EPS ..; chunks at or past d are zeros.
template <typename T, int EPS, int NS>
__device__ __forceinline__ void norm_row(const T* __restrict__ xr,
                                         const float* __restrict__ scale,
                                         int d, float eps, int lane,
                                         float (&v)[NS][EPS]) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c0 = (32 * i + lane) * EPS;
    if (c0 < d) {
      if constexpr (EPS == 1)
        v[i][0] = progen::to_f32(xr[c0]);
      else
        progen::load16(xr + c0, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPS; ++e) v[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPS; ++e) {
      s += v[i][e];
      ss += v[i][e] * v[i][e];
    }
  }
  s = progen::warp_sum(s);
  ss = progen::warp_sum(ss);
  float mu, rstd;
  progen::norm_stats(s, ss, d, eps, &mu, &rstd);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c0 = (32 * i + lane) * EPS;
    if (c0 >= d) continue;
#pragma unroll
    for (int e = 0; e < EPS; ++e)
      v[i][e] = (v[i][e] - mu) * (rstd * scale[c0 + e]);
  }
}

// Channels [lo, hi) of v (or zeros) into the output row orow.
template <typename T, int EPS, int NS>
__device__ __forceinline__ void store_part(T* __restrict__ orow,
                                           const float (&v)[NS][EPS],
                                           int d, int lo, int hi, int lane,
                                           bool zero) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c0 = (32 * i + lane) * EPS;
    if (c0 >= d || c0 >= hi || c0 + EPS <= lo) continue;
    float y[EPS];
#pragma unroll
    for (int e = 0; e < EPS; ++e) y[e] = zero ? 0.f : v[i][e];
    if constexpr (EPS > 1) {
      if (c0 >= lo && c0 + EPS <= hi) {
        progen::store16(orow + c0, y);
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < EPS; ++e)  // a chunk that the split cuts
      if (c0 + e >= lo && c0 + e < hi)
        orow[c0 + e] = progen::from_f32<T>(y[e]);
  }
}

template <typename T, int EPS, int NS>
__global__ void __launch_bounds__(WARPS * 32)
    norm_shift_kernel(const T* __restrict__ x, const T* __restrict__ prev,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int rows, int n, int d, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= rows) return;
  const int split = d - d / 2;
  float v[NS][EPS];
  norm_row<T, EPS, NS>(x + (size_t)r * d, scale, d, eps, lane, v);
  T* orow = out + (size_t)r * d;
  store_part<T, EPS, NS>(orow, v, d, split, d, lane, false);
  if ((r + 1) % n != 0)  // the next row of the sequence shifts this one in
    store_part<T, EPS, NS>(orow + d, v, d, 0, split, lane, false);
  if (r % n == 0) {  // row 0's shifted half: zeros, or the previous row
    if (prev != nullptr)
      norm_row<T, EPS, NS>(prev + (size_t)(r / n) * d, scale, d, eps, lane,
                           v);
    store_part<T, EPS, NS>(orow, v, d, 0, split, lane, prev == nullptr);
  }
}

// The smallest NS (a power of two) whose NS * 32 chunks of EPS cover d;
// at most 64 values a lane, which NORM_SHIFT_MAX_DIM (2048) needs.
template <typename T, int EPS, int NS = 1>
int launch(const void* x, const void* prev, const void* scale, void* out,
           int rows, int n, int d, float eps, cudaStream_t stream) {
  if constexpr (NS * EPS > 64) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (NS * 32 * EPS < d)
      return launch<T, EPS, 2 * NS>(x, prev, scale, out, rows, n, d, eps,
                                    stream);
    const int blocks = (rows + WARPS - 1) / WARPS;
    norm_shift_kernel<T, EPS, NS><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(prev),
        static_cast<const float*>(scale), static_cast<T*>(out), rows, n, d,
        eps);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// x, out: (rows, d) contiguous, rows = batch * n; scale: (d,) float32;
// prev: (rows / n, d) contiguous in x's dtype, each sequence's row before
// its row 0, or nullptr for none. 16-byte vectors when d is a multiple of
// one and x, prev and out are 16-byte aligned; one element a lane
// otherwise.
extern "C" int norm_shift(const void* x, const void* prev, const void* scale,
                          void* out, int rows, int n, int d, float eps,
                          int dtype, void* stream) {
  if (rows <= 0 || n <= 0 || rows % n != 0 || d < 2)
    return (int)cudaErrorInvalidValue;
  const bool aligned = progen::aligned16(x) && progen::aligned16(prev) &&
                       progen::aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype, {
    constexpr int EPS = 16 / sizeof(T);
    if (aligned && d % EPS == 0)
      return launch<T, EPS>(x, prev, scale, out, rows, n, d, eps, s);
    return launch<T, 1>(x, prev, scale, out, rows, n, d, eps, s);
  });
  return (int)cudaErrorInvalidValue;
}
