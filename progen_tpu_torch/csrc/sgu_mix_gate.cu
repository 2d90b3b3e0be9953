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
// What bounds it on this card: bytes. x, gate and the output move
// 3 * B * n * d elements, W 4 n^2 bytes: 104.9 MB at the base shapes (B =
// 8, n = 1024, d = 2048), 0.0313 ms at 3.35 TB/s. The causal product is
// B * d * n(n+1)/2 multiply-adds, 17.2 GFLOP: 0.017 ms on the bfloat16
// tensor cores, but 0.26 ms on the float32 FMA units.
//
// bfloat16 (sgu_mix_tc_kernel): the mix on the tensor cores, exactly.
// Because g is rounded to bfloat16 before the mix, it is the B operand of
// a bfloat16 product as it stands. W is float32: each warp splits the W
// values of its A fragments in registers into W_hi = bf16(W) and W_lo =
// bf16(W - W_hi), and mix = W_hi g + W_lo g, both on mma.sync m16n8k16
// with float32 accumulators (the primitives of attention_tc.cuh). Every
// product of a bfloat16 W part and a bfloat16 g is exact in float32, so
// the split reproduces W to 16 of its 24 significant bits (W_hi + W_lo is
// within 2^-17 |W| of W) and the only other departure from the FMA kernel
// is the order of the float32 sums. No TF32. Two terms cost twice the products
// of one (34.4 GFLOP at the base shapes), still under the byte bound at
// the tensor cores' peak. The gate is normalised by a first pass
// (sgu_gate_norm, one warp a row: its statistics, then g in bfloat16 into
// a (B, n, dp) scratch, dp = d rounded up to 8 with zero columns): one
// more write of B * n * d elements, where normalising each gate tile in
// the mix would repeat the work n / BM times over. Tiles: a block of 8
// warps owns 128 output rows m x 128 channels c (a warp 32 x 64) and walks
// j in tiles of 32 from j = 0 to its last row. The float32 W tile (4 MB of
// W in all, which stays in L2 across the batch) and the g tile arrive by
// cp.async, double-buffered, into padded shared rows; a warp reads its W
// fragments as float2 and splits them as it builds the A operands, so no
// register holds a tile in flight. In the diagonal tiles W above the
// diagonal is zeroed before the split; tiles with j past the block's last
// row are never loaded, nor those past a warp's last row multiplied (the
// causal skip).
// The grid is walked heaviest first: the row blocks near n, which carry
// the most tiles, have the lowest block index. The epilogue adds the bias
// in float32, rounds to T, stages the tile in shared memory and writes
// x * gate as 16-byte rows.
//
// float16 and float32 (sgu_mix_kernel): the float32 FMA units. A classic
// register-tiled SGEMM: each block owns a 64 x 64 (rows m, channels c)
// output tile and walks j in tiles of 16, normalising and rounding each
// gate tile as it stages it in shared memory (statistics from
// sgu_gate_stats, one warp a row). float16's 5-bit exponent cannot hold
// the split of a W of ~1e-6 (the initial SGU weights: sgu_init_eps / n):
// W_lo, and often W_hi, would flush to zero. float32 keeps the TPU
// kernel's arithmetic.
//
// Sequence shards: the TPU path shards the weight's output rows over the
// seq axis (partition.py's sgu_seq_out rule). A shard computes output rows
// [row0, row0 + rows) against the whole gate: x, out and the weights' and
// biases' rows are the shard's, the gate and its statistics span all n
// positions. Every output element still sums j = 0, 1, ... in the same
// tiles from j = 0, with the same terms (the zero weights above the
// diagonal add exact zeros), so a sharded mix is bit-equal to the whole
// one. row0 = 0, rows = n is the unsharded call.
#include <type_traits>

#include "attention_tc.cuh"

namespace {

// float16 and float32: the FMA kernel
constexpr int BM = 64;  // output rows m per block
constexpr int BN = 64;  // channels c per block
constexpr int BK = 16;  // reduction (j) tile
constexpr int THREADS = 256;
constexpr int STATS_WARPS = 8;  // gate rows per block of the row passes

// bfloat16: the tensor-core kernel
namespace tc {
constexpr int BM = 128;  // output rows m per block
constexpr int BN = 128;  // channels c per block
constexpr int BK = 32;   // j per tile
constexpr int THREADS = 256;  // 8 warps: 4 along m x 2 along c, 32 x 64 each
// shared row strides, in elements: the float32 W tile's 40 puts the 8
// rows that a fragment's float2 reads touch on 8 disjoint bank groups;
// the g tile's is padded by 16 bytes, as progen_attn_tc::Padded
constexpr int LDW = BK + 8;
constexpr int LDB = BN + 8;
constexpr int W_ELEMS = BM * LDW;  // one float32 W tile
constexpr int B_ELEMS = BK * LDB;  // one g tile
// two buffers of W (float32) and g (T); the epilogue's [BM][LDB] output
// tile reuses the W buffers
constexpr int SMEM = 2 * W_ELEMS * 4 + 2 * B_ELEMS * 2;
static_assert(BM * LDB * 2 <= 2 * W_ELEMS * 4, "the output tile fits");
constexpr int W_LOADS = BM * BK / 4 / THREADS;  // 16-byte chunks of W
constexpr int G_LOADS = BK * BN / 8 / THREADS;  // 16-byte chunks of g
constexpr int W_STEP = THREADS / (BK / 4);  // W rows between a thread's
constexpr int G_STEP = THREADS / (BN / 8);  // chunks, and g rows
}  // namespace tc

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
                   int n, int ldw, int shard_row0, int shard_rows,
                   int d) {
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
                       ? w[(size_t)m * ldw + j]
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

// One warp a gate row: its float32 statistics, then g = round_T((gate -
// mean) * (rstd * scale)) into row r of gn (rows, dp), whose columns d ..
// dp are zeros. vec: d % 8 == 0 and gate 16-byte aligned, so the row is
// read and written 16 bytes at a time (gn always is aligned).
template <typename T>
__global__ void __launch_bounds__(STATS_WARPS * 32)
    sgu_gate_norm(const T* __restrict__ gate, const float* __restrict__ scale,
                  T* __restrict__ gn, int rows, int d, int dp, float eps,
                  int vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * STATS_WARPS + warp;
  if (r >= rows) return;
  const T* gr = gate + (size_t)r * d;
  T* orow = gn + (size_t)r * dp;
  float s = 0.f, ss = 0.f;
  if (vec) {
#pragma unroll 4
    for (int c = 8 * lane; c < d; c += 256) {
      float v[8];
      progen::load16(gr + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float v = progen::to_f32(gr[c]);
      s += v;
      ss += v * v;
    }
  }
  s = progen::warp_sum(s);
  ss = progen::warp_sum(ss);
  float mu, rstd;
  progen::norm_stats(s, ss, d, eps, &mu, &rstd);
  if (vec) {
    // the row again, from L1: the warp read it a moment ago
#pragma unroll 4
    for (int c = 8 * lane; c < d; c += 256) {
      float v[8];
      progen::load16(gr + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * (rstd * scale[c + e]);
      progen::store16(orow + c, v);
    }
  } else {
    for (int c = lane; c < dp; c += 32)
      orow[c] = progen::from_f32<T>(
          c < d ? (progen::to_f32(gr[c]) - mu) * (rstd * scale[c]) : 0.f);
  }
}

// The mix on the tensor cores (bfloat16): grid (batch * ctiles, ceil(rows
// / BM)), tc::THREADS threads, tc::SMEM bytes of dynamic shared memory.
// gn: the normalised gate (batch, n, dp) from sgu_gate_norm. Block
// (blockIdx.x, blockIdx.y) owns batch row b = blockIdx.x / ctiles,
// channels c0 .. c0 + BN and the shard's output rows m0 .. m0 + BM, with
// the last row block first (blockIdx.y = 0). Per tile of 32 j, the
// float32 W tile and the g tile arrive by cp.async (double-buffered); a
// warp builds its A fragments from the float32 W (zeroed above the
// diagonal), splits each value into hi and lo in registers, and adds hi
// g and then lo g. W's rows are ldw floats apart, ldw a multiple of 4 and
// w 16-byte aligned, so W arrives 16 bytes at a time (the wrapper pads
// the rows of a W whose n is not a multiple of 4 with zero columns; the
// columns past a row's diagonal are zeroed in shared memory in any case);
// vec_x: d % 8 == 0 and x, out 16-byte aligned (16-byte output rows).
template <typename T>
__global__ void __launch_bounds__(tc::THREADS, 2)
    sgu_mix_tc_kernel(const T* __restrict__ x, const T* __restrict__ gn,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int n, int ldw, int row0, int rows, int d, int dp,
                      int ctiles, int vec_x) {
  namespace pt = progen_attn_tc;
  using pt::Mma;
  using tc::B_ELEMS, tc::BK, tc::BM, tc::BN, tc::G_LOADS, tc::G_STEP,
      tc::LDB, tc::LDW, tc::THREADS, tc::W_ELEMS, tc::W_LOADS, tc::W_STEP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [2 buffers][BM][LDW]
  T* bs = reinterpret_cast<T*>(ws + 2 * W_ELEMS);  // [2 buffers][BK][LDB]

  const int b = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x - b * ctiles) * BN;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // the warp's 32 rows, 64 channels
  const int g = lane / 4, tq = lane % 4;
  const T* gb = gn + (size_t)b * n * dp;
  // j < kend: past the block's last row every weight is zero
  const int kend = min(row0 + m0 + BM, n);
  const int ntiles = (kend + BK - 1) / BK;

  // The thread's chunks of a tile: W rows wr + W_STEP i (i < W_LOADS),
  // columns wq .. wq + 4 (float32); g rows gr + G_STEP i (i < G_LOADS),
  // channels gc .. gc + 8. Offsets within W and within the batch row's
  // gate fit an int. Chunks of W rows past the shard's (i W_STEP >=
  // wrows), of columns at or past kend (k0 >= wcols) and of g rows at or
  // past kend or channels at or past dp (k0 + i G_STEP >= grows) are
  // zero-filled.
  const int wr = tid / (BK / 4), wq = 4 * (tid % (BK / 4));
  const int gr = tid / (BN / 8), gc = 8 * (tid % (BN / 8));
  const float* wsrc = w + (size_t)(m0 + wr) * ldw + wq;
  const T* gsrc = gb + gr * dp + c0 + gc;
  const uint32_t wdst = pt::smem_u32(ws + wr * LDW + wq);  // in buffer 0
  const uint32_t gdst = pt::smem_u32(bs + gr * LDB + gc);
  const int wrows = rows - m0 - wr, wcols = kend - wq;
  const int grows = c0 + gc < dp ? kend - gr : 0;
  auto load_w = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < W_LOADS; ++i) {
      const bool ok = W_STEP * i < wrows && k0 < wcols;
      pt::cp_async16(wdst + (buf * W_ELEMS + W_STEP * i * LDW) * 4,
                     ok ? wsrc + W_STEP * i * ldw + k0 : w, ok ? 16 : 0);
    }
  };
  auto load_g = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < G_LOADS; ++i) {
      const bool ok = k0 + G_STEP * i < grows;
      const void* src = gsrc + (k0 + G_STEP * i) * dp;
      pt::cp_async16(gdst + (buf * B_ELEMS + G_STEP * i * LDB) * 2,
                     ok ? src : w, ok ? 16 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the shared address of the thread's B fragment rows (ldmatrix .trans)
  // in buffer 0
  const uint32_t gfrag =
      pt::smem_u32(bs + (lane % 8 + ((lane / 8) & 1) * 8) * LDB + 64 * wn +
                   (lane / 16) * 8);
  const int wfirst = row0 + m0 + 32 * wm;  // the warp's first row
  // the shared address of the thread's first W value in its A fragments:
  // row 32 wm + g, column 2 tq, of buffer 0
  const uint32_t wfrag =
      pt::smem_u32(ws + (32 * wm + g) * LDW + 2 * tq);
  load_w(0, 0);
  load_g(0, 0);
  pt::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1, k0 = t * BK;
    if (t + 1 < ntiles) {
      load_w(k0 + BK, cur ^ 1);
      load_g(k0 + BK, cur ^ 1);
      pt::cp_async_commit();
      pt::cp_async_wait<1>();
    } else {
      pt::cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 + BK - 1 > row0 + m0) {
      // a diagonal tile: its weights above the diagonal (j > row0 + m)
      // are zeroed in shared memory
      float* wt = ws + cur * W_ELEMS;
      for (int e = tid; e < BM * BK; e += THREADS)
        if (k0 + e % BK > row0 + m0 + e / BK) wt[e / BK * LDW + e % BK] = 0.f;
      __syncthreads();
    }
    // a tile past the warp's last row would add exact zeros: skipped
    if (k0 <= wfirst + 31) {
      const uint32_t wt = wfrag + cur * W_ELEMS * 4;
      const uint32_t gt = gfrag + cur * B_ELEMS * 2;
      // one k step at a time: unrolled, the two steps' fragments and
      // addresses outgrow the 128 registers that two blocks an SM leave
#pragma unroll 1
      for (int kk = 0; kk < BK / 16; ++kk) {
        // the A fragments of each of the warp's two 16-row tiles:
        // element (row g + 8 h, column 2 tq + 8 s + e), split into hi and lo
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t fh[4], fl[4];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 v = pt::lds_f2(
                  wt + ((16 * i + 8 * h) * LDW + 16 * kk + 8 * s) * 4);
              const float hx = progen::round_to<T>(v.x);
              const float hy = progen::round_to<T>(v.y);
              fh[2 * s + h] = Mma<T>::pack(hx, hy);
              fl[2 * s + h] = Mma<T>::pack(v.x - hx, v.y - hy);
            }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            uint32_t fb[4];
            pt::ldsm_x4_t(fb, gt + (16 * kk * LDB + 16 * p) * 2);
            Mma<T>::run(acc[i][2 * p], fh, fb[0], fb[1]);
            Mma<T>::run(acc[i][2 * p + 1], fh, fb[2], fb[3]);
            Mma<T>::run(acc[i][2 * p], fl, fb[0], fb[1]);
            Mma<T>::run(acc[i][2 * p + 1], fl, fb[2], fb[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // round_T(mix + bias), staged as a [BM][LDB] tile over the W buffers
  T* os = reinterpret_cast<T*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * wm + 16 * i + g + 8 * h;
      const float bm = m0 + r < rows ? bias[m0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pt::store2(os + r * LDB + 64 * wn + 8 * j + 2 * tq,
                   acc[i][j][2 * h] + bm, acc[i][j][2 * h + 1] + bm);
    }
  __syncthreads();
  // out = round_T(x * gate), 16 bytes at a time where the rows allow
  constexpr int CH = BN / 8;
  for (int e = tid; e < BM * CH; e += THREADS) {
    const int r = e / CH, ch = e % CH;
    const int m = m0 + r, c = c0 + 8 * ch;
    if (m >= rows || c >= d) continue;
    const size_t idx = ((size_t)b * rows + m) * d + c;
    const T* gv = os + r * LDB + 8 * ch;
    if (vec_x) {
      float xv[8], gf[8];
      progen::load16(x + idx, xv);
      progen::load16(gv, gf);
#pragma unroll
      for (int k = 0; k < 8; ++k) xv[k] *= gf[k];
      progen::store16(out + idx, xv);
    } else {
      for (int k = 0; k < 8 && c + k < d; ++k)
        out[idx + k] = progen::from_f32<T>(progen::to_f32(x[idx + k]) *
                                           progen::to_f32(gv[k]));
    }
  }
}

template <typename T>
int launch_tc(const T* x, const T* gate, const float* w, const float* bias,
              const float* scale, T* out, T* gn, int batch, int n, int ldw,
              int row0, int rows, int d, float eps, cudaStream_t stream) {
  using progen::aligned16;
  if (ldw % 4 != 0 || !aligned16(w)) return (int)cudaErrorInvalidValue;
  const int dp = (d + 7) / 8 * 8;
  const int gate_rows = batch * n;
  sgu_gate_norm<T><<<(gate_rows + STATS_WARPS - 1) / STATS_WARPS,
                     STATS_WARPS * 32, 0, stream>>>(
      gate, scale, gn, gate_rows, d, dp, eps, d % 8 == 0 && aligned16(gate));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto kernel = sgu_mix_tc_kernel<T>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM);
  if (err != 0) return err;
  const int ctiles = (d + tc::BN - 1) / tc::BN;
  const dim3 grid(batch * ctiles, (rows + tc::BM - 1) / tc::BM);
  kernel<<<grid, tc::THREADS, tc::SMEM, stream>>>(
      x, gn, w, bias, out, n, ldw, row0, rows, d, dp, ctiles,
      d % 8 == 0 && aligned16(x) && aligned16(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const T* x, const T* gate, const float* w, const float* bias,
               const float* scale, T* out, float2* stats, int batch, int n,
               int ldw, int row0, int rows, int d, float eps,
               cudaStream_t stream) {
  const int gate_rows = batch * n;
  sgu_gate_stats<T><<<(gate_rows + STATS_WARPS - 1) / STATS_WARPS,
                      STATS_WARPS * 32, 0, stream>>>(gate, stats, gate_rows,
                                                     d, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((d + BN - 1) / BN, (rows + BM - 1) / BM, batch);
  if (row0 == 0 && rows == n)
    sgu_mix_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        x, gate, w, bias, scale, stats, out, n, ldw, row0, rows, d);
  else
    sgu_mix_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        x, gate, w, bias, scale, stats, out, n, ldw, row0, rows, d);
  return (int)cudaGetLastError();
}

// The element type chooses the kernel.
template <typename T>
int launch(const void* x, const void* gate, const void* w, const void* bias,
           const void* scale, void* out, void* scratch, int batch, int n,
           int ldw, int row0, int rows, int d, float eps,
           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gate);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(bias);
  const float* st = static_cast<const float*>(scale);
  T* ot = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tc<T>(xt, gt, wt, bt, st, ot, static_cast<T*>(scratch),
                        batch, n, ldw, row0, rows, d, eps, stream);
  else
    return launch_fma<T>(xt, gt, wt, bt, st, ot,
                         static_cast<float2*>(scratch), batch, n, ldw, row0,
                         rows, d, eps, stream);
}

}  // namespace

// gate: (batch, n, d) contiguous; x, out: (batch, rows, d), the output
// rows [row0, row0 + rows), in the gate's dtype; weights (rows, n) and
// biases (rows,) float32, those rows of the (n, n) and (n,) parameters,
// the weights' rows ldw >= n floats apart (for bfloat16 ldw a multiple
// of 4 and the weights 16-byte aligned);
// scale (d,) float32; scratch, 16-byte aligned: for bfloat16 the
// normalised gate, batch * n * dp elements (dp = d rounded up to 8), for
// float16 and float32 the gate's statistics, batch * n float2.
extern "C" int sgu_mix_gate(const void* x, const void* gate,
                            const void* weights, const void* biases,
                            const void* scale, void* out, void* scratch,
                            int batch, int n, int ldw, int row0, int rows,
                            int d, float eps, int dtype, void* stream) {
  if (batch <= 0 || n <= 0 || ldw < n || d <= 0 || batch > 65535 ||
      rows <= 0 || row0 < 0 || row0 + rows > n ||
      (rows + BM - 1) / BM > 65535 || !progen::aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype,
                        return launch<T>(x, gate, weights, biases, scale,
                                         out, scratch, batch, n, ldw, row0,
                                         rows, d, eps, s));
  return (int)cudaErrorInvalidValue;
}

