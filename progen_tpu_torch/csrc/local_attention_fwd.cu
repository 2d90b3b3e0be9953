// Windowed causal local-attention forward.
//
// Replaces: progen_tpu/ops/pallas_attention.py:_fwd (kernel body
// _fwd_kernel, softmax _softmax_rows_batched). Same function: query row a
// of window i sees the keys of [window i-1 | window i] with concatenated
// index j <= a + w; window 0's previous window is w zero keys with score 0
// and value 0 that still count in the softmax denominator; scores and
// softmax in float32; the output in the input dtype.
//
// What bounds it on this card: at the base configuration (n = 1024,
// w = 512, d = 64, bfloat16) a query row meets 513 keys on average, 4 * d
// operations each (q.k and p.v), against 4 * d * 2 bytes of q, k, v and
// output per row: about 256 operations per byte, just under the tensor
// cores' balance of 295, so bytes set the least time with operations
// close behind.
//
// bfloat16 and float16 (fwd_tc_kernel) run both products on the tensor
// cores, with attention_tc.cuh's primitives. A block of 4 warps owns 64
// query rows of one (batch * head, window), 16 a warp; its Q tile is read
// once through shared memory into registers (ldmatrix). The keys its rows
// need arrive in 64-key tiles of K and V by cp.async into padded shared
// rows, double-buffered; tiles above the block's last row are never
// loaded, and a warp skips a tile that starts past its last row. Per
// tile, a warp forms S = Q K^T (16 x 64, mma.sync m16n8k16, float32
// accumulators) scaled by scale * log2(e), masks keys past the range's
// end or past the row to -inf (only on a tile that reaches past the
// range's end or the warp's first row), updates its online softmax (row
// max over the 4 lanes of a row, ex2, each tile's row sum reduced over
// those 4 lanes before it enters l), and adds P V to its float32 output
// (V through ldmatrix.trans). The output, O / l rounded to T, is staged in
// the warp's rows of the Q tile and stored as 16-byte rows.
//
// Rounding: P (the unnormalised exp2(s - m), at most 1, summed into l in
// float32) enters P V as two T values, its rounding to T and the
// remainder rounded to T, each through its own product: about 16
// significant bits in bfloat16, where the TPU kernel keeps float32's 24.
// One rounding of P to T (as the backward kernels round P and dS) costs a
// third fewer products, but moved the base model's scores further from
// the plain path than chip_smoke.py's phase 4 allows (1e-2 nats a
// sequence).
//
// float32 (local_attention_fwd_kernel) is the simple first version on the
// FMA units: one thread owns one query row and keeps its q row and its
// float32 output accumulator in registers, and a block of TQ threads walks
// the keys its rows need in shared-memory tiles of TK keys with an online
// softmax (running max and denominator, rescaled once per CH keys). Its
// arithmetic is that of the TPU kernel: P.V in float32.
//
// The tensor-core kernel walks the keys of window i in two ranges, each
// cut into tiles from its own start: the previous window [(i-1) w, i w)
// and the window's own keys; the FMA kernel walks them as one range. Both
// start window 0's running softmax with max 0 and denominator w: exactly
// the w phantom keys of score 0 and value 0, which they never load.
//
// With a halo (A4; replaces pallas_local_attention_halo, the same TPU
// kernel with two _halo_spec operands, pallas_attention.py:514, :549-551):
// window 0's previous window is the (w, d) halo slab of keys and values
// that the left neighbouring sequence shard sent, not the phantom zeros.
// Window 0 then walks keys -w .. a (the halo at -w .. -1) and starts its
// online softmax at max -inf and denominator 0, as every other window
// does: the same tiles, in the same order, as the window that follows
// window 0 on the whole sequence, so a sharded forward is bit-equal to the
// whole one. A zero halo leaves the tensor-core kernel's state where the
// phantom start puts it (score 0, exactly w ones summed, a zero output).
// The halo is a template flag: with hk = hv = nullptr the launch takes the
// instantiation without one.
#include <initializer_list>
#include <type_traits>

#include "attention_tc.cuh"

namespace {

constexpr int TQ = 128;  // query rows per block, one per thread
constexpr int TK = 32;   // keys per shared-memory tile
constexpr int CH = 8;    // keys per online-softmax rescale

template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(TQ)
    local_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ hk,
                               const T* __restrict__ hv, T* __restrict__ o,
                               int n, int w, float scale) {
  __shared__ __align__(16) float ks[TK][D];
  __shared__ __align__(16) float vs[TK][D];

  const int bh = blockIdx.z;
  const int win = blockIdx.y;
  const int a0 = blockIdx.x * TQ;
  const int a = a0 + threadIdx.x;  // row within the window
  const bool active = a < w;
  const size_t base = (size_t)bh * n * D;
  const int row = win * w + a;  // absolute query row

  float qr[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? progen::to_f32(q[base + (size_t)row * D + c]) : 0.f;
    acc[c] = 0.f;
  }
  // Window 0 without a halo: w phantom keys of score 0 and value 0
  // already seen. With a halo its previous keys are real, at -w .. -1.
  const bool phantom = !HALO && win == 0;
  float m = phantom ? 0.f : -INFINITY;
  float l = phantom ? (float)w : 0.f;
  const size_t hbase = (size_t)bh * w * D;

  const int kbeg = phantom ? 0 : (win - 1) * w;
  const int kend = win * w + min(a0 + TQ, w);  // exclusive

  for (int t0 = kbeg; t0 < kend; t0 += TK) {
    for (int idx = threadIdx.x; idx < TK * D; idx += TQ) {
      const int kk = idx / D;
      const int c = idx - kk * D;
      const int j = t0 + kk;
      float kv = 0.f, vv = 0.f;
      if (HALO && j < 0) {  // window 0's previous keys: the halo
        kv = progen::to_f32(hk[hbase + (size_t)(j + w) * D + c]);
        vv = progen::to_f32(hv[hbase + (size_t)(j + w) * D + c]);
      } else if (j < kend) {
        kv = progen::to_f32(k[base + (size_t)j * D + c]);
        vv = progen::to_f32(v[base + (size_t)j * D + c]);
      }
      ks[kk][c] = kv;
      vs[kk][c] = vv;
    }
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (int c0 = 0; c0 < TK; c0 += CH) {
        float s[CH];
        float cmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int j = t0 + c0 + c;
          const float4* kr = reinterpret_cast<const float4*>(ks[c0 + c]);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < D / 4; ++e) {
            const float4 kk4 = kr[e];
            dot = fmaf(qr[4 * e + 0], kk4.x, dot);
            dot = fmaf(qr[4 * e + 1], kk4.y, dot);
            dot = fmaf(qr[4 * e + 2], kk4.z, dot);
            dot = fmaf(qr[4 * e + 3], kk4.w, dot);
          }
          s[c] = (j < kend && j <= row) ? dot * scale : -INFINITY;
          cmax = fmaxf(cmax, s[c]);
        }
        const float m_new = fmaxf(m, cmax);
        if (m_new == -INFINITY) continue;  // nothing visible yet
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float p = expf(s[c] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs[c0 + c]);
#pragma unroll
          for (int e = 0; e < D / 4; ++e) {
            const float4 vv4 = vr[e];
            acc[4 * e + 0] = fmaf(p, vv4.x, acc[4 * e + 0]);
            acc[4 * e + 1] = fmaf(p, vv4.y, acc[4 * e + 1]);
            acc[4 * e + 2] = fmaf(p, vv4.z, acc[4 * e + 2]);
            acc[4 * e + 3] = fmaf(p, vv4.w, acc[4 * e + 3]);
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < D; ++c)
      o[base + (size_t)row * D + c] = progen::from_f32<T>(acc[c] * inv);
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to 0
// (exp2f adds instructions to keep them, which no softmax term needs)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr int FWD_SMEM = 5 * progen_attn_tc::TILE *
                         progen_attn_tc::Padded<D>::LD * 2;

// Forward on tensor cores (bfloat16, float16): grid (bh, n / w,
// ceil(w / TILE)), THREADS threads, FWD_SMEM<D> bytes of dynamic shared
// memory: the Q tile (later the output) and two buffers each of K and V.
// A block owns TILE rows a0 .. of window i, warp r of it rows a0 + 16 r
// ... The grid is walked from the last rows of the last window down, so
// the blocks with the most keys start first and the light ones fill the
// tail (blockIdx.x, which the card dispatches first, is the batch *
// head). The keys are walked in two ranges, each cut into TILE-key tiles
// from its own start: the previous window [(i-1) w, i w) (skipped with
// the phantom start; from the halo for window 0 with HALO) and the
// window's own keys up to the block's last row. A warp skips a tile that
// starts past its last row: every score masked, the update would leave
// (m, l, O) bit for bit as they are.
template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(progen_attn_tc::THREADS)
    fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ hk,
                  const T* __restrict__ hv, T* __restrict__ o, int n, int w,
                  float scale) {
  using namespace progen_attn_tc;
  constexpr int LD = Padded<D>::LD, NK = TILE / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [TILE][LD]: Q, then the output
  T* ks = qs + TILE * LD;              // [2][TILE][LD]
  T* vs = ks + 2 * TILE * LD;          // [2][TILE][LD]

  const int bh = blockIdx.x, win = gridDim.y - 1 - blockIdx.y;
  const int a0 = (gridDim.z - 1 - blockIdx.z) * TILE;
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

  const int first_row = w0 + a0 + 16 * warp;  // the warp's first row
  const bool live = a0 + 16 * warp < w;
  const int rows[2] = {first_row + g, first_row + g + 8};
  const float c = scale * LOG2E;

  // Window 0 without a halo: w phantom keys of score 0 and value 0
  // already seen.
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = phantom ? 0.f : -INFINITY;
    l[h] = phantom ? (float)w : 0.f;
  }
  float acc[ND][4], s[NK][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[D / 16][4];  // the warp's 16 Q rows as mma A fragments

  // the Q tile travels with the first key tile
  load_rows<T, TILE, D, false>(qs, q + base, nullptr, w0 + a0, w0 + w, w);
  load_kv(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_kv(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      const int ar = (lane % 8) + ((lane / 8) & 1) * 8, ac = (lane / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + (16 * warp + ar) * LD + ac + 16 * kk);
    }
    const int t0 = tile_start(i), end = tile_end(i);
    if (live && t0 <= first_row + 15) {
      // S = Q K^T over the tile's 64 keys
      const T* kt = ks + (i & 1) * TILE * LD;
      const int br = (lane / 16) * 8 + lane % 8, bc = ((lane / 8) & 1) * 8;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NK / 2; ++p) {
          uint32_t fb[4];
          ldsm_x4(fb, kt + (16 * p + br) * LD + bc + 16 * kk);
          Mma<T>::run(s[2 * p], qf[kk], fb[0], fb[1]);
          Mma<T>::run(s[2 * p + 1], qf[kk], fb[2], fb[3]);
        }
      // the mask: keys past the range's end or past the row, which only a
      // tile reaching past either can hold
      const bool edge = t0 + TILE > end || t0 + TILE - 1 > first_row;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + 8 * j + 2 * tq + (e & 1);
          const bool vis = !edge || (key < end && key <= rows[e / 2]);
          s[j][e] = vis ? s[j][e] * c : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
        }
      float ms[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // nothing visible yet: keep every term 0 rather than exp(nan)
        ms[h] = m_new == -INFINITY ? 0.f : m_new;
        const float corr = ex2(m[h] - ms[h]);
        l[h] *= corr;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * h] *= corr;
          acc[j][2 * h + 1] *= corr;
        }
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - ms[e / 2]);  // p, in float32
          ls[e / 2] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the 4 lanes of a row end with one value, bit for bit
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
        ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
        l[h] += ls[h];
      }
      // O += P V with P in two T parts: its rounding to T, then the
      // remainder P - round(P) rounded to T
      const T* vt = vs + (i & 1) * TILE * LD;
      acc_product<T, D, TILE>(s, vt, acc, lane);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] -= progen::round_to<T>(s[j][e]);
      acc_product<T, D, TILE>(s, vt, acc, lane);
    }
    __syncthreads();
  }
  if (!live) return;

  // O / l rounded to T, staged in the warp's own 16 rows of the Q tile
  // (no other warp reads them) and stored as 16-byte rows
  T* ow = qs + 16 * warp * LD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(ow + (g + 8 * h) * LD + 8 * j + 2 * tq) =
          Mma<T>::pack(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, ch = idx - r * CPR;
    const int row = first_row + r;
    if (row < w0 + w)
      *reinterpret_cast<uint4*>(o + base + (size_t)row * D + ch * 8) =
          *reinterpret_cast<const uint4*>(ow + r * LD + ch * 8);
  }
}

// bfloat16 and float16 on the tensor cores.
template <typename T, int D>
int launch_tc(const T* q, const T* k, const T* v, const T* hk, const T* hv,
              T* o, int bh, int n, int w, float scale, cudaStream_t stream) {
  using namespace progen_attn_tc;
  constexpr int smem = FWD_SMEM<D>;
  const dim3 grid(bh, n / w, (w + TILE - 1) / TILE);
  auto kernel = hk != nullptr ? fwd_tc_kernel<T, D, true>
                              : fwd_tc_kernel<T, D, false>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, hk, hv, o, n, w, scale);
  return (int)cudaGetLastError();
}

// float32 on the FMA units.
template <typename T, int D>
int launch_fma(const T* q, const T* k, const T* v, const T* hk, const T* hv,
               T* o, int bh, int n, int w, float scale,
               cudaStream_t stream) {
  const dim3 grid((w + TQ - 1) / TQ, n / w, bh);
  if (hk != nullptr)
    local_attention_fwd_kernel<T, D, true><<<grid, TQ, 0, stream>>>(
        q, k, v, hk, hv, o, n, w, scale);
  else
    local_attention_fwd_kernel<T, D, false><<<grid, TQ, 0, stream>>>(
        q, k, v, hk, hv, o, n, w, scale);
  return (int)cudaGetLastError();
}

// The element type chooses the kernel.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, void* o, int bh, int n, int w, float scale,
           cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* hkt = static_cast<const T*>(hk);
  const T* hvt = static_cast<const T*>(hv);
  T* ot = static_cast<T*>(o);
  if constexpr (!std::is_same<T, float>::value)
    return launch_tc<T, D>(qt, kt, vt, hkt, hvt, ot, bh, n, w, scale,
                           stream);
  else
    return launch_fma<T, D>(qt, kt, vt, hkt, hvt, ot, bh, n, w, scale,
                            stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* hk,
             const void* hv, void* o, int bh, int n, int w, int d,
             float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, hk, hv, o, bh, n, w, scale, s);
    case 32: return launch<T, 32>(q, k, v, hk, hv, o, bh, n, w, scale, s);
    case 64: return launch<T, 64>(q, k, v, hk, hv, o, bh, n, w, scale, s);
    case 128: return launch<T, 128>(q, k, v, hk, hv, o, bh, n, w, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (bh, n, d) contiguous, one dtype, 16-byte aligned.
// n % w == 0. hk, hv: (bh, w, d) halo keys and values in the same dtype,
// both or neither (nullptr: window 0 sees the phantom zeros).
extern "C" int local_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* hk,
                                   const void* hv, void* out, int bh, int n,
                                   int w, int d, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || w <= 0 || n % w != 0 || bh > 65535 || n / w > 65535 ||
      (hk == nullptr) != (hv == nullptr))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, hk, hv, (const void*)out})
    if (!progen_attn_tc::aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype,
                        return launch_d<T>(q, k, v, hk, hv, out, bh, n, w, d,
                                           scale, s));
  return (int)cudaErrorInvalidValue;
}
