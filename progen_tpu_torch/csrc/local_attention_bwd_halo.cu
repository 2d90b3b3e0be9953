// Windowed causal local-attention backward, q-centric with a halo (A3).
//
// Replaces: progen_tpu/ops/pallas_attention.py:_bwd_core, halo branch
// (call at :683, kernel body _bwd_kernel). Same function: program i gives
// dq_i from its own softmax row and float32 gradients dk2, dv2 for all 2w
// keys of its [prev | cur] pair, into a (bh, n / w, 2w, d) float32
// scratch. The overlap is resolved outside the kernel, as the TPU path
// does in XLA (`combine`, pallas_attention.py:704-713, here
// ops/cuda_attention.py:_halo_combine): window i's dk is program i's
// current half plus program i+1's previous half, and program 0's previous
// half (the gradient of the phantom zero keys) is dropped. dq is written
// in the input dtype.
//
// What bounds it on this card: the function needs 5 products of 2 d
// operations over the visible (query, key) pairs (21.5 GFLOP at bh = 64,
// n = 1024, w = 512, d = 64: 0.022 ms at the tensor cores' 989 TFLOP/s)
// against q, k, v, dO, dq, dk and dv in bfloat16 (59 MB, 0.018 ms at
// 3.35 TB/s): bound by operations. This kernel computes 9 products (the
// row pass S and dP twice and dQ, the key pass S, dP, dV, dK again) and
// also writes the two float32 scratches (67 MB) that the combine reads.
//
// Design: the TPU kernel holds the (w, 2w) float32 probability block of
// its window in VMEM (2 MB at w = 512); a Hopper block cannot. Two
// launches here, neither storing a probability block:
//  1. the row pass (shared with A2): per query row the softmax
//     statistics (max, denominator, delta = sum p * dp) into a (bh, n)
//     float32 scratch, and dq_i;
//  2. the key pass: a block owns 64 keys of the pair [window i-1 |
//     window i] (zeros for window 0's phantom keys, which still have
//     score 0 and a probability), 16 a warp, with their float32 dk2, dv2
//     accumulators in registers; the rows of window i that see the
//     block's keys (row a sees key c when c <= a + w) stream through
//     shared memory in tiles with their statistics, and each tile gives
//     S^T, dP^T, P and dS, then dV += P^T dO and dK += dS^T Q.
// The key blocks wholly inside program 0's previous half are skipped:
// the combine never reads them, and the halo's gradient (A4) comes from
// halo_grads.
//
// bfloat16 and float16 (local_attention_bwd_tc.cuh): every product on
// the tensor cores (mma.sync m16n8k16, float32 accumulators); row and key
// tiles of 64 (key-pass row tiles of 32 at d = 128, for registers),
// staged by cp.async into padded shared rows, double-buffered; P and dS
// rounded to the input dtype before the products that take them (the
// TPU kernel keeps them in float32), S and dP exact. float32: the FMA
// kernels of local_attention_bwd.cuh and halo_kernel below, unchanged
// (tensor cores cannot give float32's accuracy); the element type
// chooses, no switch does.
//
// With a halo (A4, the halo branch of pallas_local_attention_halo's
// backward): the row pass takes window 0's previous keys from hk, hv. The
// float32 halo_kernel also holds the halo keys in program 0's previous
// half, a gradient the combine drops, as the TPU path does; the
// tensor-core key pass skips those blocks.
#include <initializer_list>
#include <type_traits>

#include "local_attention_bwd.cuh"
#include "local_attention_bwd_tc.cuh"

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

// Key pass on tensor cores: grid (ceil(2w / TILE), n / w, bh), THREADS
// threads, Shape<D>::KEYS_SMEM bytes of dynamic shared memory. Block
// (x, i) owns keys c = TILE x .. of program i's pair [window i-1 |
// window i] (sequence position (i-1) w + c), warp r of it c + 16 r ...;
// the rows of window i from the first that sees the block's keys stream
// in tiles of RT, the next in flight while this one is used. A warp skips
// a tile whose rows all lie before its keys.
template <typename T, int D, bool HALO>
__global__ void __launch_bounds__(progen_attn_tc::THREADS)
    halo_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ hk,
                   const T* __restrict__ hv, const T* __restrict__ dout,
                   const float4* __restrict__ stats, float* __restrict__ dk2,
                   float* __restrict__ dv2, int n, int w, float scale) {
  using namespace progen_attn_tc;
  constexpr int LD = Shape<D>::LD, RT = Shape<D>::RT, ND = D / 8;
  const int bh = blockIdx.z, win = blockIdx.y, cb = blockIdx.x * TILE;
  // program 0's previous half: the combine drops it
  if (win == 0 && cb + TILE <= w) return;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + TILE * LD;
  T* qs = vs + TILE * LD;    // [2][RT][LD]
  T* dos = qs + 2 * RT * LD;  // [2][RT][LD]
  float4* st = reinterpret_cast<float4*>(dos + 2 * RT * LD);  // [2][RT]

  const int nw = n / w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * n * D;
  const float4* stb = stats + (size_t)bh * n;
  const int key0 = (win - 1) * w + cb;  // the block's first key
  // rows a of window i with a + w >= the block's first key
  const int rbeg = win * w + max(0, cb - w);
  const int rend = (win + 1) * w;  // exclusive
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
  const bool live = cb + 16 * warp < 2 * w;
  const float c = scale * LOG2E;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // keys past the pair are zeros; window 0's previous keys the halo or
  // the phantom zeros
  const T* hkb = HALO ? hk + (size_t)bh * w * D : nullptr;
  const T* hvb = HALO ? hv + (size_t)bh * w * D : nullptr;
  load_rows<T, TILE, D, HALO>(ks, k + base, hkb, key0, rend, w);
  load_rows<T, TILE, D, HALO>(vs, v + base, hvb, key0, rend, w);
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
    const int cc = cb + 16 * warp + lane / 4 + 8 * h;  // key within the pair
    if (cc >= 2 * w) continue;
    const size_t off =
        (((size_t)bh * nw + win) * 2 * w + cc) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<float2*>(dk2 + off + 8 * j) =
          make_float2(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv2 + off + 8 * j) =
          make_float2(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

template <typename T, int D>
int launch_tc(const T* q, const T* k, const T* v, const T* hk, const T* hv,
              const T* dout, T* dq, float* dk2, float* dv2, float4* stats,
              int bh, int n, int w, float scale, cudaStream_t stream) {
  using namespace progen_attn_tc;
  int err = launch_rows<T, D>(q, k, v, hk, hv, dout, dq, stats, bh, n, w,
                              scale, stream);
  if (err != 0) return err;
  constexpr int smem = Shape<D>::KEYS_SMEM;
  auto kernel = hk != nullptr ? halo_tc_kernel<T, D, true>
                              : halo_tc_kernel<T, D, false>;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  const dim3 grid((2 * w + TILE - 1) / TILE, n / w, bh);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, hk, hv, dout, stats, dk2,
                                          dv2, n, w, scale);
  return (int)cudaGetLastError();
}

// float32: the FMA row pass and halo_kernel.
template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* hk,
               const void* hv, const void* dout, void* dq, void* dk2,
               void* dv2, void* stats, int bh, int n, int w, float scale,
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

// bfloat16 and float16 on the tensor cores, float32 on the FMA units.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, const void* dout, void* dq, void* dk2, void* dv2,
           void* stats, int bh, int n, int w, float scale,
           cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value)
    return launch_tc<T, D>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(hk),
        static_cast<const T*>(hv), static_cast<const T*>(dout),
        static_cast<T*>(dq), static_cast<float*>(dk2),
        static_cast<float*>(dv2), static_cast<float4*>(stats), bh, n, w,
        scale, stream);
  else
    return launch_fma<T, D>(q, k, v, hk, hv, dout, dq, dk2, dv2, stats, bh,
                            n, w, scale, stream);
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
  for (const void* p : {q, k, v, hk, hv, dout, (const void*)dq,
                        (const void*)dk2, (const void*)dv2,
                        (const void*)stats})
    if (!progen_attn_tc::aligned16(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype, return launch_d<T>(q, k, v, hk, hv, dout, dq,
                                                  dk2, dv2, stats, bh, n, w,
                                                  d, scale, s));
  return (int)cudaErrorInvalidValue;
}
