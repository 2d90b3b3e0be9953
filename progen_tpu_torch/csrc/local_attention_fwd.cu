// Windowed causal local-attention forward.
//
// Replaces: progen_tpu/ops/pallas_attention.py:_fwd (kernel body
// _fwd_kernel, softmax _softmax_rows_batched). Same function: query row a
// of window i sees the keys of [window i-1 | window i] with concatenated
// index j <= a + w; window 0's previous window is w zero keys with score 0
// and value 0 that still count in the softmax denominator; scores,
// softmax and P.V in float32; the output in the input dtype.
//
// What bounds it on this card: at the base configuration (n = 1024,
// w = 512, d = 64, bfloat16) a query row meets 513 keys on average, 4 * d
// operations each (q.k and p.v), against 4 * d * 2 bytes of q, k, v and
// output per row: about 256 operations per byte, just under the tensor
// cores' balance of 295, so bytes set the least time with operations
// close behind. On the float32 FMA units this kernel uses (67 TFLOP/s,
// a balance of 20) it is bound by operations.
//
// Design: the TPU kernel holds a (g, w, 2w) probability block in VMEM;
// here one thread owns one query row and keeps its q row and its float32
// output accumulator in registers, and a block of TQ threads walks the
// keys its rows need in shared-memory tiles of TK keys with an online
// softmax (running max and denominator, rescaled once per CH keys), so no
// (w, 2w) block is ever stored. Window 0 starts its running softmax with
// max 0 and denominator w: exactly the w phantom keys of score 0 and
// value 0. Keys past a row's own position are masked; key tiles past the
// block's last row are never loaded. The products run on the float32
// FMA units in float32 (no tensor cores), which keeps the kernel's
// arithmetic that of the TPU kernel; this is the simple first version,
// far from the bound.
//
// With a halo (A4; replaces pallas_local_attention_halo, the same TPU
// kernel with two _halo_spec operands, pallas_attention.py:514, :549-551):
// window 0's previous window is the (w, d) halo slab of keys and values
// that the left neighbouring sequence shard sent, not the phantom zeros.
// Window 0 then walks keys -w .. a (the halo at -w .. -1) and starts its
// online softmax at max -inf and denominator 0, as every other window
// does: the same tiles, in the same order, as the window that follows
// window 0 on the whole sequence, so a sharded forward is bit-equal to the
// whole one. The halo is a template flag: with hk = hv = nullptr the
// launch takes the instantiation without one, which is the kernel as it
// was before halos existed.
#include "common.cuh"

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* hk,
           const void* hv, void* o, int bh, int n, int w, float scale,
           cudaStream_t stream) {
  const dim3 grid((w + TQ - 1) / TQ, n / w, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* hkt = static_cast<const T*>(hk);
  const T* hvt = static_cast<const T*>(hv);
  T* ot = static_cast<T*>(o);
  if (hk != nullptr)
    local_attention_fwd_kernel<T, D, true><<<grid, TQ, 0, stream>>>(
        qt, kt, vt, hkt, hvt, ot, n, w, scale);
  else
    local_attention_fwd_kernel<T, D, false><<<grid, TQ, 0, stream>>>(
        qt, kt, vt, hkt, hvt, ot, n, w, scale);
  return (int)cudaGetLastError();
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

// q, k, v, out: (bh, n, d) contiguous, one dtype. n % w == 0. hk, hv:
// (bh, w, d) halo keys and values in the same dtype, both or neither
// (nullptr: window 0 sees the phantom zeros).
extern "C" int local_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* hk,
                                   const void* hv, void* out, int bh, int n,
                                   int w, int d, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || w <= 0 || n % w != 0 || bh > 65535 || n / w > 65535 ||
      (hk == nullptr) != (hv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PROGEN_DISPATCH_DTYPE(dtype,
                        return launch_d<T>(q, k, v, hk, hv, out, bh, n, w, d,
                                           scale, s));
  return (int)cudaErrorInvalidValue;
}
