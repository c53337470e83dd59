// W4A8 matmul for few activation rows: int8 activations against the packed
// weight values as int8, integer group partials, scales and zero corrections
// applied to the partials. out[m, N] ~= x[m, K] @ W; NOT exact: the
// activations are rounded to 8 bits per token and group.
//
// Replaces: exllamav2_tpu/ops/qmm.py:_w4a8_segment_matmul (the Pallas kernel
// at qmm.py:404) and the activation quantization in front of it
// (qmm.py:313-320), which the reference leaves to XLA.
//
// Function (one uniform-bit segment, groups of gr rows, G = K / gr):
//   pass 1, per token i and group g (quantize_kernel):
//     amax = max |x[i, g]|, a = amax * (1/127), aq = amax > 0 ? a : 1,
//     xq = clamp(rint(x / aq), -127, 127) as int8, x1a = sum(xq) * a;
//   pass 2, per group (w4a8_kernel):
//     p = sum_r xq[i, r] * (v[r, n] - off) in int32, off = 128 for 8-bit
//     planes (values 0..255 shifted into int8 range), else 0; then in f32
//       compressed GPTQ meta (bf16 s, bf16 zs = (z - off) * s):
//                      term = p * a * s - x1a * zs
//       plain GPTQ meta (f32 s, int32 z):
//                      term = (p * a - x1a * (z - off)) * s
//       EXL2 (bf16 scale_f):
//                      term = (p * a - x1a * (2^(bits-1) - off)) * s
//     out[i, n] = sum_g term. The three forms round at different points and
//     are kept apart; the f32 steps use the non-contracting intrinsics, so
//     each term is bitwise the plain version's (ops/qmm.py:qmm_w4a8_plain)
//     and only the order of the f32 sum over groups differs.
// The integer dot is exact for every group size (|p| <= 127 * 255 * gr fits
// int32 up to gr = 66,000). The plain version takes it in f32, exact while
// 127 * 255 * gr < 2^24, so the wrapper refuses gr > 512. A group is a
// divisor or a multiple of the 256-row sub-block.
//
// Bound on the H100: memory. A row tile of m <= 32 does 2*m integer
// operations for every 0.5-1 byte of weight, far below the int8 ridge of the
// card, so the least time is the weight and meta bytes over 3.35 TB/s. The
// dp4a form of the product (one thread per column, 16 values unpacked with
// shifts, masks and ors, then 4 dp4a per token and 16 rows) spends ~7 ALU
// operations per weight value at m = 16 and reached 11-19 % of that bound:
// the ALU chain, not the stream, set its time.
//
// The plane layout puts natural row r of a 256-row sub-block in word
// (r mod Qsb) at slot (r div Qsb), Qsb = 8 * bits of the plane: one slot of
// all Qsb words is a run of Qsb consecutive rows. Both templates walk the
// rows of a sub-block in natural order, so one set of int32 accumulators
// serves one group at a time, whatever gr is (the cheap nibble split,
// word & 0x0F0F0F0F, would pair rows 64 apart, which cross a group at
// gr <= 64). Two templates, chosen by shape (ops/qmm.py:w4a8_template):
//   * mma (8 <= m <= 32, gr a multiple of 32, n % 8 == 0): int8 tensor-core
//     tiles, mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, m = 16 one A
//     tile, m = 32 two. The mma's k index is the plane's word index: k-step
//     ks covers rows 32ks..32ks+31, which sit in four-word runs of one slot
//     (4 bits: slot ks of words 0..31; 2 bits: slots 2ks, 2ks+1 of words
//     0..15; 8 bits: slot ks/2 of words 32(ks&1)..+31; the 1- and 2-bit
//     second plane of 3/5/6-bit values likewise), so a lane gathers its
//     four k-consecutive values for a B register from one byte of four
//     words with three prmt, one shift and one mask, and the A fragment
//     reads the activations of rows 32ks + k in natural order: neither
//     operand is permuted. A k-step never crosses a group (gr >= 32).
//     Block: 4 warps x 32 columns (n-tile j, mma column c is the warp's
//     column 4c + j, so a lane's words for its four n-tiles are one 16-byte
//     shared-memory load); the sub-blocks of a split pass through a
//     two-stage cp.async pipeline (plane tiles, XOR-swizzled against bank
//     conflicts; int8 activations; the groups' scale / zero rows, a, x1a).
//     At each group end the int32 accumulator fragment (lane l: tokens l/4,
//     l/4 + 8; columns 8(l%4) + 4h + j) gets the bitwise fix-up above;
//   * dp4a (m < 8, groups of 16 rows, or n % 8 != 0): one thread per output
//     column, the Qsb words of its column for the sub-block in registers,
//     16 values packed four to a register in row order against the int8
//     activations in shared memory. One or four tokens would waste 15/16 or
//     3/4 of an m16 tile, and a 32-row k-step would cross a 16-row group.
// Both: 128 columns per block, K split across blockIdx.y (a split holds
// whole groups) with a fixed-order second pass (reduce_splits), as in qmm.cu;
// the f32 sum over a split's groups is sequential in row order.
// Later work: wgmma / TMA, a Hopper-native repack of the planes, the
// quantization pass fused into the previous op.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;
constexpr int SB = 256;
constexpr int NCHUNK = SB / 16;
constexpr float INV127 = 0x1.020408p-7f;   // float32(1 / 127)

enum { META_SCALE_F = 0, META_GPTQ = 1, META_GPTQ_BF = 2 };

struct Args {
  const int8_t* xq;       // [m, k_pad]
  const float* a;         // [m, groups]
  const float* x1a;       // [m, groups]
  int m, k_pad, groups;
  const uint32_t* p0;
  const uint32_t* p1;
  int n, bits, group_rows, meta;
  const void* meta0;
  const void* meta1;
  float* dst;             // [splits, m, n] partials, or out when splits == 1
  int sb_per_split, nsb;
};

// one warp per (token, group)
__global__ void quantize_kernel(const float* __restrict__ x, int k_pad,
                                int gr, int groups, int8_t* __restrict__ xq,
                                float* __restrict__ a,
                                float* __restrict__ x1a) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  if (g >= groups) return;
  const size_t base = (size_t)r * k_pad + (size_t)g * gr;
  float amax = 0.f;
  for (int i = lane; i < gr; i += 32) amax = fmaxf(amax, fabsf(x[base + i]));
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fmul_rn(amax, INV127);
  const float aq = amax > 0.f ? sc : 1.f;
  int sum = 0;
  for (int i = lane; i < gr; i += 32) {
    float q = rintf(__fdiv_rn(x[base + i], aq));
    q = fminf(fmaxf(q, -127.f), 127.f);
    const int qi = (int)q;
    xq[base + i] = (int8_t)qi;
    sum += qi;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) {
    a[(size_t)r * groups + g] = sc;
    x1a[(size_t)r * groups + g] = __fmul_rn((float)sum, sc);
  }
}

// scale and zero term of group g at column col, as the fix-up wants them
__device__ __forceinline__ void load_meta(const Args& a, int g, int col,
                                          float& s, float& z) {
  const size_t i = (size_t)g * a.n + col;
  const int off = a.bits == 8 ? 128 : 0;
  if (a.meta == META_GPTQ) {
    s = static_cast<const float*>(a.meta0)[i];
    z = (float)(static_cast<const int*>(a.meta1)[i] - off);
  } else if (a.meta == META_GPTQ_BF) {
    s = __bfloat162float(static_cast<const __nv_bfloat16*>(a.meta0)[i]);
    z = __bfloat162float(static_cast<const __nv_bfloat16*>(a.meta1)[i]);
  } else {
    s = __bfloat162float(static_cast<const __nv_bfloat16*>(a.meta0)[i]);
    z = (float)((1 << (a.bits - 1)) - off);
  }
}

template <int BP0, int BP1, int MT>
__global__ void __launch_bounds__(COLS) w4a8_kernel(const Args a) {
  constexpr int QSB0 = SB * BP0 / 32;       // plane-0 words per sub-block
  constexpr int PER0 = 32 / BP0;            // slots per plane-0 word
  constexpr int NCH = QSB0 / 16;            // 16-row chunks per slot
  constexpr int QSB1 = BP1 ? SB * BP1 / 32 : 1;
  constexpr uint32_t MASK0 = (1u << BP0) - 1u;
  constexpr uint32_t MASK1 = BP1 ? (1u << BP1) - 1u : 0u;
  // 8-bit values: v - 128 as a signed byte is v ^ 0x80
  constexpr uint32_t OFFX = (BP0 == 8 && BP1 == 0) ? 0x80808080u : 0u;
  static_assert(QSB0 % 16 == 0, "plane 0 needs >= 16 words per sub-block");
  static_assert(BP1 == 0 || QSB1 == 8 || QSB1 == 16, "plane 1 is 1 or 2 bits");

  __shared__ __align__(16) int xs[MT][SB / 4];   // int8 x 4, natural order
  // per 16-row chunk of the sub-block: its group's scale and zero term for
  // the thread's column, and its group's a and x1a for each token
  __shared__ float cs[NCHUNK][COLS];
  __shared__ float cz[NCHUNK][COLS];
  __shared__ float sa[NCHUNK][MT];
  __shared__ float sx[NCHUNK][MT];

  const int col = blockIdx.x * COLS + threadIdx.x;
  const bool live = col < a.n;
  const int gr = a.group_rows;
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);

  int iacc[MT];
  float facc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    iacc[i] = 0;
    facc[i] = 0.f;
  }

  for (int sb = sb0; sb < sb1; ++sb) {
    __syncthreads();                        // previous sub-block's reads done
    for (int i = threadIdx.x; i < MT * (SB / 4); i += COLS) {
      const int r = i / (SB / 4), w = i % (SB / 4);
      xs[r][w] = r < a.m
          ? reinterpret_cast<const int*>(
                a.xq + (size_t)r * a.k_pad + (size_t)sb * SB)[w]
          : 0;
    }
    for (int i = threadIdx.x; i < NCHUNK * MT; i += COLS) {
      const int c = i / MT, r = i % MT;
      const size_t gi = (size_t)r * a.groups + (sb * SB + c * 16) / gr;
      sa[c][r] = r < a.m ? a.a[gi] : 0.f;
      sx[c][r] = r < a.m ? a.x1a[gi] : 0.f;
    }
    if (live) {
      float s = 0.f, z = 0.f;
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) {
        const int row = sb * SB + c * 16;
        if (c == 0 || row % gr == 0) load_meta(a, row / gr, col, s, z);
        cs[c][threadIdx.x] = s;
        cz[c][threadIdx.x] = z;
      }
    }
    __syncthreads();
    if (!live) continue;

    uint32_t w0[QSB0];
#pragma unroll
    for (int i = 0; i < QSB0; ++i)
      w0[i] = a.p0[((size_t)sb * QSB0 + i) * a.n + col];
    uint32_t w1[QSB1];
    if (BP1) {
#pragma unroll
      for (int j = 0; j < QSB1; ++j)
        w1[j] = a.p1[((size_t)sb * QSB1 + j) * a.n + col];
    }

#pragma unroll 1
    for (int j = 0; j < PER0; ++j) {
#pragma unroll
      for (int wc = 0; wc < NCH; ++wc) {
        // rows c*16 + i (i < 16) of the sub-block: slot j of words
        // wc*16 + i
        const int c = j * NCH + wc;
        int pk[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t t = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = q * 4 + b;
            uint32_t v = (w0[wc * 16 + i] >> (j * BP0)) & MASK0;
            if (BP1) {
              // plane 1: row r lives in word r % QSB1 (== i % QSB1 since
              // 16 % QSB1 == 0) at slot r / QSB1
              const int r = c * 16 + i;
              v |= ((w1[i % QSB1] >> ((r / QSB1) * BP1)) & MASK1) << BP0;
            }
            t |= v << (8 * b);
          }
          pk[q] = (int)(t ^ OFFX);
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int4 xv = *reinterpret_cast<const int4*>(&xs[mi][c * 4]);
          int acc = iacc[mi];
          acc = __dp4a(xv.x, pk[0], acc);
          acc = __dp4a(xv.y, pk[1], acc);
          acc = __dp4a(xv.z, pk[2], acc);
          acc = __dp4a(xv.w, pk[3], acc);
          iacc[mi] = acc;
        }
        if ((sb * SB + (c + 1) * 16) % gr == 0) {
          // the chunk ends its group: fix up the integer partial
          const float s = cs[c][threadIdx.x], z = cz[c][threadIdx.x];
          const bool after = a.meta == META_GPTQ_BF;
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const float pa = __fmul_rn((float)iacc[mi], sa[c][mi]);
            const float xz = __fmul_rn(sx[c][mi], z);
            const float t = after ? __fsub_rn(__fmul_rn(pa, s), xz)
                                  : __fmul_rn(__fsub_rn(pa, xz), s);
            facc[mi] = __fadd_rn(facc[mi], t);
            iacc[mi] = 0;
          }
        }
      }
    }
  }

  if (live) {
    float* dst = a.dst + (size_t)blockIdx.y * a.m * a.n;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      if (mi < a.m) dst[(size_t)mi * a.n + col] = facc[mi];
  }
}

// ------------------------------------------------------------ mma template

constexpr int NB = COLS;             // columns per block of the mma template
constexpr int XW = SB / 4 + 4;       // words per staged activation row
constexpr int MAXG = SB / 32;        // groups per sub-block (gr >= 32)

// one pipeline stage: the sub-block's plane tiles, activations and group
// meta, at byte offsets from the stage's start
template <int BP0, int BP1, int MT>
struct Stage {
  static constexpr int Q0 = 8 * BP0, Q1 = 8 * BP1;   // words per sub-block
  static constexpr int P0 = 0;
  static constexpr int P1 = P0 + Q0 * NB * 4;
  static constexpr int XS = P1 + Q1 * NB * 4;
  static constexpr int MS = XS + MT * XW * 4;
  static constexpr int MZ = MS + MAXG * NB * 4;
  static constexpr int SA = MZ + MAXG * NB * 4;
  static constexpr int SX = SA + MAXG * MT * 4;
  static constexpr int BYTES = SX + MAXG * MT * 4;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// word w, column c of a staged plane tile [Q][NB]: 4-column chunks stay
// whole, and lanes that read words 4t..4t+3 at columns 4g..4g+3 of a warp's
// 32 (t, g < 4, 8) hit 32 different banks
__device__ __forceinline__ int swz(int w, int c) {
  return w * NB + (c ^ (((w >> 2) & 3) << 3));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t comp(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The B fragment of k-step ks (rows 32ks..32ks+31 of the sub-block), half hf
// (k = 16hf + 4t + i, i < 4), n-tile j, from the four words x[i] that hold
// natural rows 32ks + 16hf + 4t + i of a plane of width BP: those rows sit
// in one slot of four consecutive words (Q = 8 BP words a sub-block, row r
// in word r mod Q at slot r div Q), so one byte of each word, gathered with
// prmt, and one shift and mask give the four values in k order.
template <int BP>
__device__ __forceinline__ uint32_t frag(const uint4 (&x)[4], int j, int ks,
                                         int hf, int t) {
  constexpr int Q = 8 * BP;
  constexpr uint32_t MASK = 0x01010101u * ((1u << BP) - 1u);
  const int bit = ((32 * ks + 16 * hf + 4 * t) / Q) * BP;
  const int byte = bit >> 3;
  const uint32_t sel = byte | ((byte + 4) << 4);
  const uint32_t lo = __byte_perm(comp(x[0], j), comp(x[1], j), sel);
  const uint32_t hi = __byte_perm(comp(x[2], j), comp(x[3], j), sel);
  const uint32_t r = __byte_perm(lo, hi, 0x5410);
  if constexpr (BP == 8) return r;
  return (r >> (bit & 7)) & MASK;
}

// the four words (each a uint4 over the lane's four n-tiles) that hold rows
// 32ks + 16hf + 4t + i of a plane tile with Q words a sub-block
template <int Q>
__device__ __forceinline__ void words(const uint32_t* tile, int ks, int hf,
                                      int t, int cw, uint4 (&x)[4]) {
  const int w = (32 * ks + 16 * hf + 4 * t) % Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const uint4*>(&tile[swz(w + i, cw)]);
}

template <int BP0, int BP1, int MT>
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int sb, int ng) {
  using S = Stage<BP0, BP1, MT>;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * NB;
  uint32_t* p0 = reinterpret_cast<uint32_t*>(st + S::P0);
  for (int i = tid; i < S::Q0 * (NB / 4); i += COLS) {
    const int w = i / (NB / 4), c = (i % (NB / 4)) * 4;
    const bool ok = n0 + c < a.n;
    cp16(p0 + swz(w, c),
         a.p0 + ((size_t)sb * S::Q0 + w) * a.n + (ok ? n0 + c : 0), ok);
  }
  if constexpr (BP1 > 0) {
    uint32_t* p1 = reinterpret_cast<uint32_t*>(st + S::P1);
    for (int i = tid; i < S::Q1 * (NB / 4); i += COLS) {
      const int w = i / (NB / 4), c = (i % (NB / 4)) * 4;
      const bool ok = n0 + c < a.n;
      cp16(p1 + swz(w, c),
           a.p1 + ((size_t)sb * S::Q1 + w) * a.n + (ok ? n0 + c : 0), ok);
    }
  }
  for (int i = tid; i < MT * (SB / 16); i += COLS) {
    const int r = i / (SB / 16), c = (i % (SB / 16)) * 16;
    const bool ok = r < a.m;
    cp16(st + S::XS + r * XW * 4 + c,
         a.xq + (ok ? (size_t)r * a.k_pad + (size_t)sb * SB + c : 0), ok);
  }
  // the sub-block's groups: scale and zero rows, a and x1a per token
  const int g0 = sb * SB / a.group_rows;
  const int es = a.meta == META_GPTQ ? 4 : 2;     // bytes per meta value
  const int cpr = NB * es / 16;                   // 16-byte chunks a row
  for (int i = tid; i < ng * cpr; i += COLS) {
    const int r = i / cpr, cc = i % cpr;
    const int col = n0 + cc * (16 / es);
    const bool ok = col < a.n;
    const size_t off = ((size_t)(g0 + r) * a.n + (ok ? col : 0)) * es;
    cp16(st + S::MS + r * NB * 4 + cc * 16,
         static_cast<const unsigned char*>(a.meta0) + off, ok);
    if (a.meta != META_SCALE_F)
      cp16(st + S::MZ + r * NB * 4 + cc * 16,
           static_cast<const unsigned char*>(a.meta1) + off, ok);
  }
  for (int i = tid; i < ng * MT; i += COLS) {
    const int r = i / ng, j = i % ng;
    const bool ok = r < a.m;
    const size_t gi = ok ? (size_t)r * a.groups + g0 + j : 0;
    cp4(st + S::SA + (j * MT + r) * 4, a.a + gi, ok);
    cp4(st + S::SX + (j * MT + r) * 4, a.x1a + gi, ok);
  }
}

// 8 <= m <= 32, groups of a multiple of 32 rows, n % 8 == 0: four warps,
// each 32 columns as four n-tiles of mma.m16n8k32 (n-tile j, mma column c
// is the warp's column 4c + j, so a lane's four n-tiles sit in one 16-byte
// word of shared memory), MT / 16 tiles of 16 tokens; the sub-blocks of a
// split pass through a two-stage cp.async pipeline
template <int BP0, int BP1, int MT>
__global__ void __launch_bounds__(COLS) w4a8_mma_kernel(const Args a) {
  using S = Stage<BP0, BP1, MT>;
  constexpr int MTL = MT / 16;
  constexpr int NH0 = S::Q0 >= 32 ? 2 : 1;        // word sets by half
  constexpr uint32_t OFFX = (BP0 == 8 && BP1 == 0) ? 0x80808080u : 0u;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp * 32 + 4 * g;               // the lane's B columns
  const int gr = a.group_rows;
  const int ng = gr >= SB ? 1 : SB / gr;
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);
  const bool after = a.meta == META_GPTQ_BF;
  const float zconst = (float)((1 << (a.bits - 1)) - (a.bits == 8 ? 128 : 0));
  const int zoff = a.bits == 8 ? 128 : 0;

  int iacc[MTL][4][4];
  float facc[MTL][4][4];
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        iacc[mt][j][r] = 0;
        facc[mt][j][r] = 0.f;
      }

  if (sb0 < sb1) load_stage<BP0, BP1, MT>(a, smem, sb0, ng);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int sb = sb0, buf = 0; sb < sb1; ++sb, buf ^= 1) {
    if (sb + 1 < sb1)
      load_stage<BP0, BP1, MT>(a, smem + (buf ^ 1) * S::BYTES, sb + 1, ng);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const unsigned char* st = smem + buf * S::BYTES;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(st + S::P0);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(st + S::P1);
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(st + S::XS);

    uint4 w0[NH0][4], w1[4];
    if constexpr (S::Q0 <= 32) {
#pragma unroll
      for (int hf = 0; hf < NH0; ++hf) words<S::Q0>(p0, 0, hf, t, cw, w0[hf]);
    }
    if constexpr (BP1 > 0) words<S::Q1>(p1, 0, 0, t, cw, w1);

#pragma unroll
    for (int ks = 0; ks < SB / 32; ++ks) {
      uint4 x[2][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if constexpr (S::Q0 == 64) {
          words<64>(p0, ks, hf, t, cw, x[hf]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[hf][i] = w0[hf % NH0][i];
        }
      }
      uint32_t af[MTL][4];
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) {
        const uint32_t* xr = xs + (mt * 16 + g) * XW + 8 * ks + t;
        af[mt][0] = xr[0];
        af[mt][1] = xr[8 * XW];
        af[mt][2] = xr[4];
        af[mt][3] = xr[8 * XW + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t v = frag<BP0>(x[hf], j, ks, hf, t);
          if constexpr (BP1 > 0) v |= frag<BP1>(w1, j, ks, hf, t) << BP0;
          bf[hf] = v ^ OFFX;
        }
#pragma unroll
        for (int mt = 0; mt < MTL; ++mt) mma_s8(iacc[mt][j], af[mt], bf);
      }

      if ((sb * SB + 32 * (ks + 1)) % gr == 0) {
        // the k-step ends its group: fix up the integer partials. Lane
        // register r of n-tile j is the warp's column 8t + 4(r & 1) + j,
        // token 16mt + g + 8(r >> 1)
        const int lg = gr >= SB ? 0 : 32 * ks / gr;
        const int c0 = warp * 32 + 8 * t;
        float s[8], z[8];
        if (a.meta == META_GPTQ) {
          const float* ms = reinterpret_cast<const float*>(st + S::MS);
          const int* mz = reinterpret_cast<const int*>(st + S::MZ);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            s[q] = ms[lg * NB + c0 + q];
            z[q] = (float)(mz[lg * NB + c0 + q] - zoff);
          }
        } else {
          const __nv_bfloat16* ms =
              reinterpret_cast<const __nv_bfloat16*>(st + S::MS);
          const __nv_bfloat16* mz =
              reinterpret_cast<const __nv_bfloat16*>(st + S::MZ);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            s[q] = __bfloat162float(ms[lg * 2 * NB + c0 + q]);
            z[q] = after ? __bfloat162float(mz[lg * 2 * NB + c0 + q])
                         : zconst;
          }
        }
        const float* sa = reinterpret_cast<const float*>(st + S::SA) + lg * MT;
        const float* sx = reinterpret_cast<const float*>(st + S::SX) + lg * MT;
#pragma unroll
        for (int mt = 0; mt < MTL; ++mt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int tok = mt * 16 + g + 8 * (r >> 1);
            const float av = sa[tok], xv = sx[tok];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int q = 4 * (r & 1) + j;
              const float pa = __fmul_rn((float)iacc[mt][j][r], av);
              const float xz = __fmul_rn(xv, z[q]);
              const float tm = after ? __fsub_rn(__fmul_rn(pa, s[q]), xz)
                                     : __fmul_rn(__fsub_rn(pa, xz), s[q]);
              facc[mt][j][r] = __fadd_rn(facc[mt][j][r], tm);
              iacc[mt][j][r] = 0;
            }
          }
        }
      }
    }
    __syncthreads();                  // the stage is overwritten next
  }

  // token 16mt + g + 8e holds the warp's columns 8t + 4h + j in registers
  // 2e + h of the four n-tiles
  float* dst = a.dst + (size_t)blockIdx.y * a.m * a.n;
  const int col0 = blockIdx.x * NB + warp * 32 + 8 * t;
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = mt * 16 + g + 8 * e, col = col0 + 4 * h;
        const int r = 2 * e + h;
        if (tok < a.m && col < a.n)
          *reinterpret_cast<float4*>(dst + (size_t)tok * a.n + col) =
              make_float4(facc[mt][0][r], facc[mt][1][r], facc[mt][2][r],
                          facc[mt][3][r]);
      }
}

template <int BP0, int BP1>
void launch_mma(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.m <= 16) {
    constexpr int bytes = 2 * Stage<BP0, BP1, 16>::BYTES;
    cudaFuncSetAttribute(w4a8_mma_kernel<BP0, BP1, 16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    w4a8_mma_kernel<BP0, BP1, 16><<<grid, COLS, bytes, st>>>(a);
  } else {
    constexpr int bytes = 2 * Stage<BP0, BP1, 32>::BYTES;
    cudaFuncSetAttribute(w4a8_mma_kernel<BP0, BP1, 32>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    w4a8_mma_kernel<BP0, BP1, 32><<<grid, COLS, bytes, st>>>(a);
  }
}

// out[i] = sum over splits of part[s, i], in split order
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int splits,
                              size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * count + i];
  out[i] = s;
}

template <int BP0, int BP1>
void launch_mt(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.m <= 1)       w4a8_kernel<BP0, BP1, 1><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 4)  w4a8_kernel<BP0, BP1, 4><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 8)  w4a8_kernel<BP0, BP1, 8><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 16) w4a8_kernel<BP0, BP1, 16><<<grid, COLS, 0, st>>>(a);
  else                w4a8_kernel<BP0, BP1, 32><<<grid, COLS, 0, st>>>(a);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [m, k_pad] f32, or null when the caller has quantized already: then
// pass 1 is skipped and xq, a, x1a are inputs; else they are scratch: xq
// [m, k_pad] int8, a and x1a [m, k_pad / group_rows] f32; planes
// int32/uint32 [k_pad*bp/32, n]; meta as in load_meta; part [splits, m, n]
// f32 (ignored when splits == 1); out [m, n]. use_mma picks the mma template
// (groups of a multiple of 32 rows, n % 8 == 0, 16-byte aligned buffers),
// else the dp4a template runs. A split holds whole groups. Returns the
// cudaError_t of the launches.
int qmm_w4a8_segment(const void* x, int m, int k_pad, void* xq, void* a_out,
                     void* x1a_out, const void* plane0, const void* plane1,
                     int bp0, int bp1, int n, int bits, int group_rows,
                     int meta, const void* meta0, const void* meta1,
                     void* part, void* out, int splits, int sb_per_split,
                     int use_mma, void* stream) {
  if (m < 1 || m > 32 || k_pad % SB || group_rows % 16 || splits < 1 ||
      k_pad % group_rows || (SB % group_rows && group_rows % SB) ||
      (group_rows > SB && splits > 1 && sb_per_split % (group_rows / SB)))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (use_mma &&
      (group_rows % 32 || n % 8 || !aligned(xq) || !aligned(plane0) ||
       !aligned(meta0) || !aligned(meta1) || !aligned(part) ||
       !aligned(out) || (bp1 && !aligned(plane1))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = k_pad / group_rows;
  cudaError_t e = cudaSuccess;
  if (x != nullptr) {
    quantize_kernel<<<dim3((groups + 3) / 4, m), 128, 0, st>>>(
        (const float*)x, k_pad, group_rows, groups, (int8_t*)xq,
        (float*)a_out, (float*)x1a_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Args a;
  a.xq = (const int8_t*)xq;
  a.a = (const float*)a_out;
  a.x1a = (const float*)x1a_out;
  a.m = m;
  a.k_pad = k_pad;
  a.groups = groups;
  a.p0 = (const uint32_t*)plane0;
  a.p1 = (const uint32_t*)plane1;
  a.n = n;
  a.bits = bits;
  a.group_rows = group_rows;
  a.meta = meta;
  a.meta0 = meta0;
  a.meta1 = meta1;
  a.dst = (float*)(splits == 1 ? out : part);
  a.sb_per_split = sb_per_split;
  a.nsb = k_pad / SB;
  dim3 grid((n + COLS - 1) / COLS, splits);
  const int key = bp0 * 10 + bp1;
  switch (use_mma ? -key : key) {
    case 20: launch_mt<2, 0>(a, grid, st); break;
    case 40: launch_mt<4, 0>(a, grid, st); break;
    case 80: launch_mt<8, 0>(a, grid, st); break;
    case 21: launch_mt<2, 1>(a, grid, st); break;
    case 41: launch_mt<4, 1>(a, grid, st); break;
    case 42: launch_mt<4, 2>(a, grid, st); break;
    case -20: launch_mma<2, 0>(a, grid, st); break;
    case -40: launch_mma<4, 0>(a, grid, st); break;
    case -80: launch_mma<8, 0>(a, grid, st); break;
    case -21: launch_mma<2, 1>(a, grid, st); break;
    case -41: launch_mma<4, 1>(a, grid, st); break;
    case -42: launch_mma<4, 2>(a, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t count = (size_t)m * n;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
