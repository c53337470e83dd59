// The bf16 tensor-core tile machinery of the dequant-matmul kernels, shared
// by csrc/qmm.cu (the fused dequant-matmul) and csrc/qmm_partials.cu (GPTQ
// scales-on-partials).
//
// A block is four warps over 128 columns. Lane (g, t) of a warp owns
// R = 2*bp0 consecutive plane-0 words of each of its four columns (the
// warp's columns 4g .. 4g + 3, one 16-byte load a word): words R*t ..
// R*t + R - 1 of a 256-row sub-block. Slot s of those words holds natural
// rows Qsb*s + R*t + i (Qsb = 8*bp0), and k-step h of the slot gives the
// mma.sync.m16n8k16 k indices 2t, 2t+1 rows 4h, 4h+1 and k indices 2t+8,
// 2t+9 rows 4h+2, 4h+3: a permutation of the rows that the activation tile
// follows. pair_bits places the values q of two rows of one column (plane 1
// joined) in the two 16-bit halves of a register.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SB = 256;             // rows of a sub-block
constexpr int WARPS = 4;
constexpr int NB = 32 * WARPS;      // columns of a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 8;       // blocks of a cluster (portable limit)
constexpr int NCH = SB / 16;        // 16-row chunks of a sub-block
constexpr int XSTR = SB + 32;       // bf16 per staged activation row

// weights are read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// (x & m) | c in one lop3 (constants in registers, not immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t x, uint32_t m,
                                           uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(r) : "r"(x), "r"(m), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// the words of one sub-block that a lane holds: plane-0 words
// R*t .. R*t + R - 1 and the plane-1 words of the same rows, each a uint4
// over the lane's four columns
template <int BP0, int BP1>
struct Words {
  static constexpr int R = 2 * BP0;
  uint4 w0[R];
  uint4 w1[BP1 ? R : 1];
};

// a lane's words of sub-block sb (planes [k_pad*bp/32, n] as uint32), its
// four columns from c4; zeros where the columns lie past n
template <int BP0, int BP1>
__device__ __forceinline__ void load_words(const uint32_t* plane0,
                                           const uint32_t* plane1, int n,
                                           int sb, int t, int c4, bool live,
                                           Words<BP0, BP1>& w) {
  constexpr int R = 2 * BP0, Q0 = 8 * BP0, Q1 = 8 * BP1;
  const uint32_t* p = plane0 + ((size_t)sb * Q0 + R * t) * n + c4;
#pragma unroll
  for (int i = 0; i < R; ++i)
    w.w0[i] = live ? ld_stream(p + (size_t)i * n) : make_uint4(0, 0, 0, 0);
  if constexpr (BP1 > 0) {
    const uint32_t* p1 = plane1 + ((size_t)sb * Q1 + (R * t) % Q1) * n + c4;
#pragma unroll
    for (int i = 0; i < R; ++i)
      w.w1[i] = live ? ld_stream(p1 + (size_t)i * n) : make_uint4(0, 0, 0, 0);
  }
}

// cp.async of `bytes` (0..P) valid bytes of a P-byte piece, the rest of the
// piece zero-filled
template <int P>
__device__ __forceinline__ void cp_piece(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (P == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(P), "r"(bytes) : "memory");
}

// plane 1 of lane t at slot S: the byte selector of its word pair and the
// rotation that brings its bits to bp0 .. bp0 + bp1 - 1 (the lane's rows
// Q0*S + R*t + i sit at slot (Q0*S + R*t) / Q1 of plane 1)
template <int BP0, int BP1, int S>
__device__ __forceinline__ void plane1_shift(int t, uint32_t& sel1,
                                             int& rot1) {
  sel1 = 0;
  rot1 = 0;
  if constexpr (BP1 > 0) {
    constexpr int R = 2 * BP0, Q0 = 8 * BP0, Q1 = 8 * BP1;
    const int sh1 = BP1 * ((Q0 * S + R * t) / Q1);
    sel1 = sh1 >= 16 ? 0x7632u : 0x5410u;
    rot1 = ((sh1 & 15) - BP0) & 31;
  }
}

// The values q of two rows (the halves of the result) of one column:
// plane-0 words a, b at slot S; plane-1 words a1, b1 selected by sel1 and
// rotated by rot1. orc is OR-ed into each half (0x4300: bf16 128 + q).
template <int BP0, int BP1, int S>
__device__ __forceinline__ uint32_t pair_bits(uint32_t wa, uint32_t wb,
                                              uint32_t w1a, uint32_t w1b,
                                              uint32_t sel1, int rot1,
                                              uint32_t orc) {
  constexpr uint32_t MASK0 = ((1u << BP0) - 1u) * 0x00010001u;
  constexpr int SH0 = (BP0 * S) & 15;
  const uint32_t p0 = __byte_perm(wa, wb, BP0 * S < 16 ? 0x5410 : 0x7632);
  uint32_t q = and_or(p0 >> SH0, MASK0, orc);
  if constexpr (BP1 > 0) {
    constexpr uint32_t MASK1 = (((1u << BP1) - 1u) << BP0) * 0x00010001u;
    const uint32_t p1 = __byte_perm(w1a, w1b, sel1);
    q = and_or(__funnelshift_r(p1, p1, rot1), MASK1, q);
  }
  return q;
}

}  // namespace
