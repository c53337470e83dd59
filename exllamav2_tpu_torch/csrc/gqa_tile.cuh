// The bf16 tensor-core tiles of the grouped-query attention kernels, shared
// by csrc/decode_attn.cu (kernel 2) and csrc/paged_attn.cu (kernel 3).
//
// The G query heads of one KV head are the M rows of mma.sync.m16n8k16
// tiles (ceil(G / 16) of them, rows past G zero), the cache rows its N (the
// scores Q.K^T) and then its K (P.V). Lane (g, t) of a warp (g = lane / 4,
// t = lane % 4) holds, in a tile's f32 accumulator, rows g and g + 8 at
// columns 2t and 2t + 1 (c0, c1 row g; c2, c3 row g + 8). Operands staged
// in shared memory are bf16 rows of stride `stride` elements, with 8
// elements of padding past the row so that the eight 16-byte rows an
// ldmatrix phase reads lie on distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gqa {

constexpr int MAX_MT = 4;         // m16 tiles of query heads a block holds
constexpr int PAD = 8;            // bf16 of padding past a staged row

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(saddr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(saddr(p))
      : "memory");
}

// c += a . b (bf16 operands, f32 accumulator)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two values as bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_of(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// eight bf16 from global memory aligned to 2 bytes only (the query rows),
// as one 16-byte value for shared memory
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  uint32_t u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = (uint32_t)__bfloat16_as_ushort(p[2 * j]) |
           ((uint32_t)__bfloat16_as_ushort(p[2 * j + 1]) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The query rows of a block, NH = 16 MT rows of d <= 256 bf16 (rows past
// `rows` zero), staged in two steps so that their loads are in flight
// together and beside the block's first cache loads: q_load issues every
// load of the thread (16-byte loads where q is 16-byte aligned), q_store
// writes them as rows of stride `stride`. 128 threads.
template <int NH>
struct QRows {
  static constexpr int P = NH * 256 / 8 / 128;    // 16-byte pieces a thread
  uint4 v[P];
};

template <int NH>
__device__ __forceinline__ void q_load(QRows<NH>& q,
                                       const __nv_bfloat16* p, int rows,
                                       int d, int tid) {
  const bool vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
#pragma unroll
  for (int j = 0; j < QRows<NH>::P; ++j) {
    const int i0 = (tid + 128 * j) * 8;
    q.v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i0 < NH * d && i0 / d < rows)
      q.v[j] =
          vec ? *reinterpret_cast<const uint4*>(p + i0) : load8(p + i0);
  }
}

template <int NH>
__device__ __forceinline__ void q_store(const QRows<NH>& q,
                                        __nv_bfloat16* s, int stride, int d,
                                        int tid) {
#pragma unroll
  for (int j = 0; j < QRows<NH>::P; ++j) {
    const int i0 = (tid + 128 * j) * 8;
    if (i0 < NH * d) {
      const int r = i0 / d;
      *reinterpret_cast<uint4*>(s + (size_t)r * stride + i0 - r * d) = q.v[j];
    }
  }
}

// A fragment of m-tile rows [r0, r0 + 16), k columns [k0, k0 + 16) of a
// staged bf16 matrix (the query rows)
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int stride,
                                       int r0, int k0, int lane) {
  ldsm_x4(a, s + (size_t)(r0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
}

// B fragment of n columns [n0, n0 + 8), k [k0, k0 + 16) from staged rows
// that hold B transposed: row n, element k (cache rows as the keys of Q.K^T)
__device__ __forceinline__ void b_frag(uint32_t (&b)[2],
                                       const __nv_bfloat16* s, int stride,
                                       int n0, int k0, int lane) {
  ldsm_x2(b, s + (size_t)(n0 + (lane & 7)) * stride + k0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragment of k rows [k0, k0 + 16), n columns [n0, n0 + 8) from staged
// rows that hold B as it is: row k, element n (cache rows as the values of
// P.V)
__device__ __forceinline__ void b_frag_t(uint32_t (&b)[2],
                                         const __nv_bfloat16* s, int stride,
                                         int k0, int n0, int lane) {
  ldsm_x2_t(b, s + (size_t)(k0 + (lane & 15)) * stride + n0);
}

// A fragment of rows [r0, r0 + 16) (rows >= rows are zero), k columns
// [k0, k0 + 16) of an f32 matrix in shared memory, each value rounded to
// bf16 (values that are bf16 already pass unchanged)
__device__ __forceinline__ void a_frag_f32(uint32_t (&a)[4], const float* s,
                                           int stride, int rows, int r0,
                                           int k0, int lane) {
  const int g = lane >> 2, c = k0 + 2 * (lane & 3);
  float2 x0 = make_float2(0.f, 0.f), x1 = x0, x2 = x0, x3 = x0;
  if (r0 + g < rows) {
    const float* p = s + (size_t)(r0 + g) * stride + c;
    x0 = *reinterpret_cast<const float2*>(p);
    x2 = *reinterpret_cast<const float2*>(p + 8);
  }
  if (r0 + g + 8 < rows) {
    const float* p = s + (size_t)(r0 + g + 8) * stride + c;
    x1 = *reinterpret_cast<const float2*>(p);
    x3 = *reinterpret_cast<const float2*>(p + 8);
  }
  a[0] = pack(x0.x, x0.y);
  a[1] = pack(x1.x, x1.y);
  a[2] = pack(x2.x, x2.y);
  a[3] = pack(x3.x, x3.y);
}

// the bf16 residue of an A fragment: x - bf16(x) rounded to bf16, for a
// two-term (hi + lo) product that keeps about 16 bits of x
__device__ __forceinline__ uint32_t residue(float x, float y, uint32_t hi) {
  return pack(x - lo_of(hi), y - hi_of(hi));
}

}  // namespace gqa
