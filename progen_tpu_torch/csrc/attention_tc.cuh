// Tensor-core building blocks of the local-attention kernels, shared by
// the forward (local_attention_fwd.cu, A1 and A4's forward) and the
// backwards (local_attention_bwd_tc.cuh and the two files that include
// it: A2, A3 and A4's backwards), in their bfloat16 and float16
// instantiations. float32 keeps the FMA kernels.
//
// Products: mma.sync.aligned.m16n8k16 with bf16/fp16 operands and float32
// accumulators (Ampere's warp-level instruction, which Hopper runs at
// about two thirds of wgmma's rate). A block is 4 warps; each warp owns
// 16 rows of a 64-row tile. The float32 accumulator of one product passes
// as the A operand of the next straight from registers: the accumulator
// layout of m16n8 is the A layout of m16k16 once two n-tiles are packed
// to T pairs (acc_product below), which rounds that operand to T.
//
// Operands reach the mma through ldmatrix from shared memory: row-major
// tiles with a row stride of D + 8 elements (Padded<D>::LD: a 16-byte
// pad, so the 8 rows of an 8x8 matrix fall in 8 different bank groups),
// plain for operands whose reduction runs along the head dim and .trans
// for those whose reduction runs along the rows. Tiles arrive by cp.async
// (16 bytes a thread, rows outside the range zero-filled by the copy
// itself), double-buffered by the kernels that use them.
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"

namespace progen_attn_tc {

constexpr int THREADS = 128;  // threads per block: 4 warps
constexpr int TILE = 64;  // rows a block owns, keys a key tile holds
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Padded {
  static constexpr int LD = D + 8;  // shared row stride, in elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Each shared-memory primitive takes a 32-bit shared address (one
// register, where a pointer takes two), or a pointer into shared memory
// that it converts.

// 16 bytes from global to shared; bytes = 0 fills the 16 with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  cp_async16(smem_u32(dst), src, bytes);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  ldsm_x4(r, smem_u32(p));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  ldsm_x4_t(r, smem_u32(p));
}
// Two float32 values from the shared address a (8-byte aligned).
__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a));
  return v;
}

// c (16 x 8, float32) += a (16 x 16) b (16 x 8), both in T.
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // (lo, hi) rounded to nearest even, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// Stage rows [r0, r0 + R) of a (rows, D) slab into dst[R][LD] with
// cp.async; rows at or past `hi` are zeros. With HALO, rows -w .. -1 come
// from the (w, D) halo slab; without it, negative rows are zeros.
template <typename T, int R, int D, bool HALO>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          const T* __restrict__ halo, int r0,
                                          int hi, int w) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int LD = Padded<D>::LD;
  for (int idx = threadIdx.x; idx < R * CPR; idx += THREADS) {
    const int rr = idx / CPR;
    const int ch = idx - rr * CPR;
    const int r = r0 + rr;
    const bool ok = r < hi && (HALO || r >= 0);
    const T* g = src;
    if (ok)
      g = (HALO && r < 0 ? halo + (ptrdiff_t)(r + w) * D
                         : src + (ptrdiff_t)r * D) +
          ch * 8;
    cp_async16(dst + rr * LD + ch * 8, g, ok ? 16 : 0);
  }
}

// out[D / 8][4] += X B for one warp: X is the warp's [16][N] float32
// accumulator (n-tile j, element e: row g + 8 (e / 2), column 8 j + 2 t +
// e % 2 with g = lane / 4, t = lane % 4), rounded to T here; B is [N][LD]
// in shared memory, reduced over its N rows.
template <typename T, int D, int N>
__device__ __forceinline__ void acc_product(const float (*x)[4], const T* b,
                                            float (*out)[4], int lane) {
  constexpr int LD = Padded<D>::LD;
  const int br = lane % 8 + ((lane / 8) & 1) * 8, bc = (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    a[0] = Mma<T>::pack(x[2 * kk][0], x[2 * kk][1]);
    a[1] = Mma<T>::pack(x[2 * kk][2], x[2 * kk][3]);
    a[2] = Mma<T>::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = Mma<T>::pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t fb[4];
      ldsm_x4_t(fb, b + (16 * kk + br) * LD + 16 * p + bc);
      Mma<T>::run(out[2 * p], a, fb[0], fb[1]);
      Mma<T>::run(out[2 * p + 1], a, fb[2], fb[3]);
    }
  }
}

// Two T values to global memory as one 4-byte store.
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = Mma<T>::pack(lo, hi);
}

// The tensor-core kernels read 16 bytes at a time: every pointer must be
// 16-byte aligned (rows are: D is a multiple of 8).
using progen::aligned16;

}  // namespace progen_attn_tc
