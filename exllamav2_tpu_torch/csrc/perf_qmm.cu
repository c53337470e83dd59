// Roofline experiments for the quantized-matmul kernels: three small kernels
// that answer, on this card, the questions the decode kernels' designs hang
// on. All take M = 8 activation rows and one packed weight plane
// [K*bits/32, N] of 32-bit words.
//
// Replaces: tools/perf_qmm.py of the JAX package -- dma_only (the Pallas
// kernel at perf_qmm.py:160), _gp_kernel_factory in its modes bf16 and int8
// (perf_qmm.py:226) and _run_nibble (perf_qmm.py:347).
//
// 1. dma_only: the streaming ceiling. Every word of the plane is read once,
//    reinterpreted as int32, converted to f32 and summed per column within a
//    K tile of 512 word rows: tiles[t, n] = sum_{r in tile t} f32(int32(
//    plane[r, n])). A ragged last tile is masked and gets a row of its own.
//    Bound: the plane's bytes over the memory rate; one add per word is far
//    below any arithmetic limit.
//    Design: a block of 8 x 32 threads covers 32 columns of one tile (a
//    128-byte line per row), so even the three tiles of a [1376, 4096]
//    plane make 384 blocks for the 132 SMs; a thread loads 16 bytes (four
//    columns), neighbouring threads neighbouring columns, and walks every
//    32nd row of the tile, its 16 loads unrolled and in flight together,
//    with four partial sums in registers; the 32 row lanes meet in shared
//    memory in a fixed order. No atomics: every (tile, column) is written
//    by one thread.
//
// 2. gp (group partials), modes bf16 and int8, on the strided-plane layout
//    (natural row r of a 256-row sub-block lives in word r mod Qsb at bit
//    slot r div Qsb, Qsb = 256*bits/32). With s = fp16(qs^2 * smax) per
//    group g and v the unpacked values:
//      bf16: y = sum_g s_g * (x_g @ f32(v_g - 8)),   x bf16, f32 sums;
//      int8: y = sum_g s_g * (f32(xq_g . int8(v_g)) - 8 * sum(xq_g)),
//            xq int8, the dot in int32 (exact).
//    Bound: memory (plane + qs + smax + x + y over the rate): 16 operations
//    per weight value at M = 8 are far below the ridge.
//    Design: one template, the mode a parameter. One thread per output
//    column, 128 columns a block, K split over blockIdx.y with a fixed-order
//    second pass. A thread holds the Qsb words of its column for a sub-block
//    in registers and walks the bit slots, so rows arrive in natural order
//    four at a time; the sub-block's activations sit in shared memory (int8
//    packed four to a word and met with dp4a, or f32), with the per-group
//    sums of xq and the decoded group scales beside them. Each group's
//    partial is fixed up where its last rows end. The f32 steps use the
//    non-contracting intrinsics, so every term is bitwise the plain
//    version's and only the order of the f32 sum over groups differs.
//
// 3. nibble (4-bit planes only): the cheap split lo = w & 0x0F0F0F0F,
//    hi = (w >> 4) & 0x0F0F0F0F; each word reinterpreted as four int8 rows.
//    ROW MAPPING A: row 4k + j of the reinterpreted plane is byte j of word
//    k, little-endian -- what a register holds on this card. Per group of gr
//    rows, word rows g*gr/8 .. (g+1)*gr/8: the first gr/2 activations meet
//    the lo bytes, the second gr/2 the hi bytes, in int32;
//    y = sum_g s_g * (f32(p_g) - 8 * x1_g), x1 [8, K/gr] the per-group sums
//    of xq (the plain version subtracts 8 * (x1 @ s) once: the same
//    function, another f32 order).
//    Bound: memory, as for gp (x1 read too).
//    Design: the arithmetic goes to the int8 tensor cores, with no repack.
//    mma.sync.m16n8k32.s8 takes the weights as A (16 output columns) and
//    the 8 activation rows as B (the n8 of the instruction). Lane (g, t)
//    loads one uint4: word t of a 4-word k-step for columns 4g .. 4g+3. In
//    A's fragment a lane holds k = 4t..4t+3 (a0, a1) and 16+4t..16+4t+3 (a2,
//    a3): for a group of 32 those are exactly lo(word t) and hi(word t), so
//    two ALU operations give a0 = lo, a2 = hi of one column; two mma take
//    the column pairs (0, 1) and (2, 3). For gr >= 64 k-step j of a group
//    takes words 4j..4j+3 and B moves to 16j and gr/2 + 16j; the int32 tile
//    spans the group's gr/32 steps. For gr 16 a k-step holds two groups
//    (lanes t < 2 the first, t >= 2 the second): one mma a group, the other
//    group's B zeroed. B is xq in natural order, 4-byte loads from the L1.
//    Per group the epilogue takes f32 of the exact int32 tile, subtracts
//    8 x1 (exact: both are integers below 2^24) and multiplies by s of the
//    column (one 4-byte qs load holds the lane's four columns), added to an
//    f32 sum in group order (non-contracting intrinsics). A block is 8 warps:
//    nt / 32 across the columns, the rest across K; the split's 256-row
//    units go round its K warps, each unit's 8 loads a lane issued together
//    (64 KB in flight an SM at two blocks). K is split over a thread-block
//    cluster (at most 16), but little: tools/perf_qmm.nibble_tiles leaves
//    every K warp a unit and about 1.5 blocks an SM, since more and shorter
//    splits measured slower (a block's fixed cost and idle K warps). The partial tiles meet in shared memory: the K
//    warps' summed in order, then the blocks' in rank order through
//    distributed shared memory, every rank's value loaded before the first
//    add: one launch, no global scratch.
//
// Later work for dma_only and gp: cp.async / TMA pipelining, mma.sync tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MROWS = 8;
constexpr int SB = 256;
constexpr int COLS = 128;
constexpr int MIN_GROUP = 16;
constexpr int MAX_GROUPS_SB = SB / MIN_GROUP;

constexpr int DMA_TILE = 512;     // word rows per K tile
constexpr int DMA_CX = 8;         // column threads of a block, 4 columns each
constexpr int DMA_RY = 32;        // row lanes of a block

__global__ void __launch_bounds__(DMA_CX * DMA_RY)
dma_only_kernel(const uint32_t* __restrict__ plane, int kq, int n,
                float* __restrict__ tiles) {
  __shared__ float part[DMA_RY][DMA_CX * 4];
  const int col = (blockIdx.x * DMA_CX + threadIdx.x) * 4;
  const int row0 = blockIdx.y * DMA_TILE;
  const int row1 = min(row0 + DMA_TILE, kq);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (col < n) {
#pragma unroll 16
    for (int r = row0 + threadIdx.y; r < row1; r += DMA_RY) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(plane + (size_t)r * n + col);
      s0 += (float)(int)w.x;
      s1 += (float)(int)w.y;
      s2 += (float)(int)w.z;
      s3 += (float)(int)w.w;
    }
  }
  float* mine = &part[threadIdx.y][threadIdx.x * 4];
  mine[0] = s0;
  mine[1] = s1;
  mine[2] = s2;
  mine[3] = s3;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int y = 0; y < DMA_RY; ++y) {
      t.x += part[y][threadIdx.x * 4 + 0];
      t.y += part[y][threadIdx.x * 4 + 1];
      t.z += part[y][threadIdx.x * 4 + 2];
      t.w += part[y][threadIdx.x * 4 + 3];
    }
    *reinterpret_cast<float4*>(tiles + (size_t)blockIdx.y * n + col) = t;
  }
}

// fp16(q^2 * smax) as f32: the EXL2 group scale
__device__ __forceinline__ float exl2_scale(int q, float smax) {
  return __half2float(__float2half_rn(__fmul_rn((float)(q * q), smax)));
}

__device__ __forceinline__ float group_scale(const uint8_t* qs,
                                             const float* smax, int g, int n,
                                             int col) {
  return exl2_scale(qs[(size_t)g * n + col], smax[g]);
}

struct GpArgs {
  const void* x;            // [8, k] bf16 or int8
  const uint32_t* plane;    // [k * bits / 32, n]
  const uint8_t* qs;        // [k / gr, n]
  const float* smax;        // [k / gr]
  int k, n, gr;
  float* dst;               // [splits, 8, n] partials, or out when splits == 1
  int sb_per_split, nsb;
};

template <int BP, bool INT8>
__global__ void __launch_bounds__(COLS) gp_kernel(const GpArgs a) {
  constexpr int QSB = SB * BP / 32;         // words per sub-block and column
  constexpr int PER = 32 / BP;              // bit slots per word
  constexpr uint32_t MASK = (1u << BP) - 1u;
  static_assert(QSB % 4 == 0, "a slot holds whole chunks of four rows");

  // the sub-block's activations in natural row order
  __shared__ __align__(16) int xi[INT8 ? MROWS : 1][INT8 ? SB / 4 : 1];
  __shared__ __align__(16) float xf[INT8 ? 1 : MROWS][INT8 ? 1 : SB];
  __shared__ float x1s[INT8 ? MROWS : 1][INT8 ? MAX_GROUPS_SB : 1];
  __shared__ float cs[MAX_GROUPS_SB][COLS];     // group scales, own column

  const int col = blockIdx.x * COLS + threadIdx.x;
  const bool live = col < a.n;
  const int gr = a.gr;
  const int ngs = SB / gr;                  // groups per sub-block
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);

  int iacc[MROWS];
  float pacc[MROWS], facc[MROWS];
#pragma unroll
  for (int m = 0; m < MROWS; ++m) {
    iacc[m] = 0;
    pacc[m] = 0.f;
    facc[m] = 0.f;
  }

  for (int sb = sb0; sb < sb1; ++sb) {
    __syncthreads();                        // previous sub-block's reads done
    if constexpr (INT8) {
      const int8_t* x = static_cast<const int8_t*>(a.x);
      for (int i = threadIdx.x; i < MROWS * (SB / 4); i += COLS) {
        const int m = i / (SB / 4), w = i % (SB / 4);
        xi[m][w] = reinterpret_cast<const int*>(
            x + (size_t)m * a.k + (size_t)sb * SB)[w];
      }
      for (int i = threadIdx.x; i < MROWS * ngs; i += COLS) {
        const int m = i / ngs, g = i % ngs;
        const int* xw = reinterpret_cast<const int*>(
            x + (size_t)m * a.k + (size_t)sb * SB + (size_t)g * gr);
        int s = 0;
        for (int w = 0; w < gr / 4; ++w) s = __dp4a(xw[w], 0x01010101, s);
        x1s[m][g] = (float)s;
      }
    } else {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
      for (int i = threadIdx.x; i < MROWS * SB; i += COLS) {
        const int m = i / SB, r = i % SB;
        xf[m][r] = __bfloat162float(x[(size_t)m * a.k + (size_t)sb * SB + r]);
      }
    }
    if (live)
      for (int g = 0; g < ngs; ++g)
        cs[g][threadIdx.x] = group_scale(a.qs, a.smax, sb * ngs + g, a.n, col);
    __syncthreads();
    if (!live) continue;

    uint32_t w[QSB];
#pragma unroll
    for (int i = 0; i < QSB; ++i)
      w[i] = a.plane[((size_t)sb * QSB + i) * a.n + col];

#pragma unroll 1
    for (int j = 0; j < PER; ++j) {
#pragma unroll
      for (int i = 0; i < QSB; i += 4) {
        const int row = j * QSB + i;        // rows row .. row + 3
        const uint32_t v0 = (w[i + 0] >> (j * BP)) & MASK;
        const uint32_t v1 = (w[i + 1] >> (j * BP)) & MASK;
        const uint32_t v2 = (w[i + 2] >> (j * BP)) & MASK;
        const uint32_t v3 = (w[i + 3] >> (j * BP)) & MASK;
        if constexpr (INT8) {
          // the values as int8 (an 8-bit value wraps, as the cast does)
          const int pk = (int)(v0 | (v1 << 8) | (v2 << 16) | (v3 << 24));
#pragma unroll
          for (int m = 0; m < MROWS; ++m)
            iacc[m] = __dp4a(xi[m][row >> 2], pk, iacc[m]);
        } else {
          const float f0 = (float)((int)v0 - 8), f1 = (float)((int)v1 - 8);
          const float f2 = (float)((int)v2 - 8), f3 = (float)((int)v3 - 8);
#pragma unroll
          for (int m = 0; m < MROWS; ++m) {
            const float4 xv = *reinterpret_cast<const float4*>(&xf[m][row]);
            float p = pacc[m];
            p = __fmaf_rn(xv.x, f0, p);
            p = __fmaf_rn(xv.y, f1, p);
            p = __fmaf_rn(xv.z, f2, p);
            p = __fmaf_rn(xv.w, f3, p);
            pacc[m] = p;
          }
        }
        if (((row + 4) & (gr - 1)) == 0) {  // the chunk ends its group
          const int g = row / gr;
          const float s = cs[g][threadIdx.x];
#pragma unroll
          for (int m = 0; m < MROWS; ++m) {
            float pc;
            if constexpr (INT8) {
              pc = __fsub_rn((float)iacc[m], __fmul_rn(8.f, x1s[m][g]));
              iacc[m] = 0;
            } else {
              pc = pacc[m];
              pacc[m] = 0.f;
            }
            facc[m] = __fadd_rn(facc[m], __fmul_rn(pc, s));
          }
        }
      }
    }
  }

  if (live) {
    float* dst = a.dst + (size_t)blockIdx.y * MROWS * a.n;
#pragma unroll
    for (int m = 0; m < MROWS; ++m) dst[(size_t)m * a.n + col] = facc[m];
  }
}

constexpr int NIB_WARPS = 8;                  // warps of a block
constexpr int NIB_THREADS = 32 * NIB_WARPS;
constexpr int NIB_STEPS = SB / 32;            // k-steps of 32 rows a unit
constexpr int NIB_MAX_SPLITS = 16;            // blocks of a cluster

struct NibArgs {
  const int8_t* xq;         // [8, k]
  const float* x1;          // [8, k / gr]
  const uint32_t* plane;    // [k / 8, n]
  const uint8_t* qs;        // [k / gr, n]
  const float* smax;        // [k / gr]
  int k, n;
  int units;                // 256-row units a split takes
  int warps_n;              // warps across the block's 32 * warps_n columns
  float* out;               // [8, n]
};

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four consecutive 32-bit words (VEC: one 16-byte load) or bytes (one
// 4-byte load) of a row from column col; columns at or past n read as 0
template <bool VEC>
__device__ __forceinline__ uint4 words4(const uint32_t* row, int col, int n) {
  if constexpr (VEC) {
    // streamed once: kept out of the L1, where xq, x1 and smax live
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col < n)
      asm volatile(
          "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
          : "l"(row + col));
    return v;
  } else {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = col + i < n ? __ldg(row + col + i) : 0u;
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <bool VEC>
__device__ __forceinline__ uint32_t bytes4(const uint8_t* p, int col, int n) {
  if constexpr (VEC) {
    return col < n ? __ldg(reinterpret_cast<const uint32_t*>(p + col)) : 0u;
  } else {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < n) v |= (uint32_t)__ldg(p + col + i) << (8 * i);
    return v;
  }
}

template <bool VEC>
__device__ __forceinline__ uint32_t xq4(const int8_t* p) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
    return (uint32_t)__ldg(b) | ((uint32_t)__ldg(b + 1) << 8) |
           ((uint32_t)__ldg(b + 2) << 16) | ((uint32_t)__ldg(b + 3) << 24);
  }
}

__device__ __forceinline__ uint32_t lo4(uint32_t w) { return w & 0x0F0F0F0Fu; }
__device__ __forceinline__ uint32_t hi4(uint32_t w) {
  return (w >> 4) & 0x0F0F0F0Fu;
}

// the two mma of one k-step: A rows g and g+8 are the lane's columns
// (4g, 4g+1), then (4g+2, 4g+3)
__device__ __forceinline__ void nib_step(int (&c)[2][4], const uint4& w,
                                         uint32_t b0, uint32_t b1) {
  mma_s8(c[0], lo4(w.x), lo4(w.y), hi4(w.x), hi4(w.y), b0, b1);
  mma_s8(c[1], lo4(w.z), lo4(w.w), hi4(w.z), hi4(w.w), b0, b1);
}

// one group's int32 tile into the f32 sums: C register 2e + mm of column
// pair p is column 4g + 2p + e, activation row 2t + mm
__device__ __forceinline__ void nib_epilogue(float (&acc)[4][2],
                                             const int (&c)[2][4],
                                             uint32_t q4, float sm, float z0,
                                             float z1) {
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float s = exl2_scale((q4 >> (8 * cc)) & 0xFF, sm);
    const int* v = &c[cc >> 1][2 * (cc & 1)];
    acc[cc][0] =
        __fadd_rn(acc[cc][0], __fmul_rn(__fsub_rn((float)v[0], z0), s));
    acc[cc][1] =
        __fadd_rn(acc[cc][1], __fmul_rn(__fsub_rn((float)v[1], z1), s));
  }
}

template <int GR, bool VEC>
__global__ void __launch_bounds__(NIB_THREADS, 2)
nibble_kernel(const NibArgs a) {
  constexpr int NG = SB / GR;                 // groups a unit
  __shared__ float red[NIB_WARPS * 32 * MROWS];     // [K warp][8][nt]
  __shared__ float blk[MROWS * 32 * NIB_WARPS];      // [8][nt], nt <= 256
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % a.warps_n, wk = warp / a.warps_n;
  const int warps_k = NIB_WARPS / a.warps_n;
  const int nt = 32 * a.warps_n;
  const int n0 = blockIdx.x * nt;
  const int col = n0 + wn * 32 + 4 * g;       // the lane's four columns
  const int groups = a.k / GR;
  const int u1 = min((int)(blockIdx.y + 1) * a.units, a.k / SB);
  const int8_t* xrow = a.xq + (size_t)g * a.k;          // B column g
  const float* x1a = a.x1 + (size_t)(2 * t) * groups;   // C columns 2t, 2t+1

  float acc[4][2];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) acc[cc][0] = acc[cc][1] = 0.f;

  for (int u = blockIdx.y * a.units + wk; u < u1; u += warps_k) {
    // every load of the unit first: 8 k-steps of plane words and B
    // fragments, then each group's scales and x1
    uint4 w[NIB_STEPS];
    uint32_t b0[NIB_STEPS], b1[NIB_STEPS];
#pragma unroll
    for (int s = 0; s < NIB_STEPS; ++s) {
      const int kb = u * SB + 32 * s;         // the step's first K row
      w[s] = words4<VEC>(a.plane + (size_t)(kb / 8 + t) * a.n, col, a.n);
      int o0, o1;
      if constexpr (GR == 16) {               // lanes t < 2: first group
        o0 = kb + 16 * (t >> 1) + 4 * (t & 1);
        o1 = o0 + 8;
      } else {
        const int gb = kb / GR * GR, j = (kb - gb) / 32;
        o0 = gb + 16 * j + 4 * t;
        o1 = o0 + GR / 2;
      }
      b0[s] = xq4<VEC>(xrow + o0);
      b1[s] = xq4<VEC>(xrow + o1);
    }
    uint32_t q[NG];
    float sm[NG], z0[NG], z1[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int grp = u * NG + i;
      q[i] = bytes4<VEC>(a.qs + (size_t)grp * a.n, col, a.n);
      sm[i] = __ldg(a.smax + grp);
      z0[i] = __fmul_rn(8.f, __ldg(x1a + grp));
      z1[i] = __fmul_rn(8.f, __ldg(x1a + groups + grp));
    }

    if constexpr (GR == 16) {
#pragma unroll
      for (int s = 0; s < NIB_STEPS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool mine = (t >> 1) == h;
          int c[2][4] = {};
          nib_step(c, w[s], mine ? b0[s] : 0u, mine ? b1[s] : 0u);
          const int i = 2 * s + h;
          nib_epilogue(acc, c, q[i], sm[i], z0[i], z1[i]);
        }
    } else {
      constexpr int SPG = GR / 32;            // k-steps a group
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        int c[2][4] = {};
#pragma unroll
        for (int s = i * SPG; s < (i + 1) * SPG; ++s)
          nib_step(c, w[s], b0[s], b1[s]);
        nib_epilogue(acc, c, q[i], sm[i], z0[i], z1[i]);
      }
    }
  }

  // the partial tiles red[wk][m][nt]: the K warps summed in order into
  // blk[m][nt], then the blocks' blk in rank order, every rank's value of an
  // element loaded before the first add (one round trip of distributed
  // shared memory, not a chain of them)
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
      red[(wk * MROWS + 2 * t + mm) * nt + wn * 32 + 4 * g + cc] =
          acc[cc][mm];
  __syncthreads();
  for (int e = threadIdx.x; e < MROWS * nt; e += NIB_THREADS) {
    float s = 0.f;
    for (int k = 0; k < warps_k; ++k) s += red[k * MROWS * nt + e];
    blk[e] = s;
  }
  const int splits = (int)gridDim.y;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync();
  else __syncthreads();
  const int rank = splits > 1 ? (int)cluster.block_rank() : 0;
  for (int e = rank * NIB_THREADS + threadIdx.x; e < MROWS * nt;
       e += splits * NIB_THREADS) {
    float v[NIB_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < NIB_MAX_SPLITS; ++r)
      v[r] = r < splits ? *cluster.map_shared_rank(blk + e, r) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < NIB_MAX_SPLITS; ++r)
      if (r < splits) s += v[r];
    const int m = e / nt, cc = e - m * nt;
    if (n0 + cc < a.n) a.out[(size_t)m * a.n + n0 + cc] = s;
  }
  if (splits > 1) cluster.sync();   // no block leaves while others read it
}

template <int GR, bool VEC>
cudaError_t launch_nibble(const NibArgs& a, dim3 grid, cudaStream_t st) {
  static bool configured = false;             // opt in once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        nibble_kernel<GR, VEC>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NIB_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nibble_kernel<GR, VEC>, a);
}

template <bool VEC>
cudaError_t launch_nibble_gr(const NibArgs& a, int gr, dim3 grid,
                             cudaStream_t st) {
  switch (gr) {
    case 16: return launch_nibble<16, VEC>(a, grid, st);
    case 32: return launch_nibble<32, VEC>(a, grid, st);
    case 64: return launch_nibble<64, VEC>(a, grid, st);
    case 128: return launch_nibble<128, VEC>(a, grid, st);
    case 256: return launch_nibble<256, VEC>(a, grid, st);
    default: return cudaErrorInvalidValue;
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

cudaError_t reduce(const void* part, void* out, int splits, int n,
                   cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t count = (size_t)MROWS * n;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)out, splits, count);
  return cudaGetLastError();
}

bool group_ok(int gr) {
  return gr >= MIN_GROUP && gr <= SB && (gr & (gr - 1)) == 0;
}

template <int BP>
void launch_gp(const GpArgs& a, bool int8, dim3 grid, cudaStream_t st) {
  if (int8) gp_kernel<BP, true><<<grid, COLS, 0, st>>>(a);
  else      gp_kernel<BP, false><<<grid, COLS, 0, st>>>(a);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// plane uint32 [kq, n] (n % 4 == 0) -> tiles f32 [ceil(kq / 512), n]
int perf_dma_only(const void* plane, int kq, int n, void* tiles,
                  void* stream) {
  if (kq < 1 || n < 4 || n % 4) return (int)cudaErrorInvalidValue;
  dim3 grid((n + DMA_CX * 4 - 1) / (DMA_CX * 4),
            (kq + DMA_TILE - 1) / DMA_TILE);
  dma_only_kernel<<<grid, dim3(DMA_CX, DMA_RY), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)plane, kq, n, (float*)tiles);
  return (int)cudaGetLastError();
}

// x [8, k] bf16 (int8_mode 0) or int8 (1); plane [k*bits/32, n]; qs uint8
// [k/gr, n]; smax f32 [k/gr]; part f32 [splits, 8, n] (ignored when splits
// == 1); out f32 [8, n]. k % 256 == 0, gr a power of two in [16, 256].
int perf_gp(const void* x, const void* plane, const void* qs,
            const void* smax, int k, int n, int bits, int gr, int int8_mode,
            void* part, void* out, int splits, int sb_per_split,
            void* stream) {
  if (k < SB || k % SB || !group_ok(gr) || splits < 1 || sb_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GpArgs a;
  a.x = x;
  a.plane = (const uint32_t*)plane;
  a.qs = (const uint8_t*)qs;
  a.smax = (const float*)smax;
  a.k = k;
  a.n = n;
  a.gr = gr;
  a.dst = (float*)(splits == 1 ? out : part);
  a.sb_per_split = sb_per_split;
  a.nsb = k / SB;
  dim3 grid((n + COLS - 1) / COLS, splits);
  switch (bits) {
    case 1: launch_gp<1>(a, int8_mode != 0, grid, st); break;
    case 2: launch_gp<2>(a, int8_mode != 0, grid, st); break;
    case 4: launch_gp<4>(a, int8_mode != 0, grid, st); break;
    case 8: launch_gp<8>(a, int8_mode != 0, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)reduce(part, out, splits, n, st);
}

// xq int8 [8, k]; x1 f32 [8, k/gr]; plane [k/8, n] (4-bit); qs, smax as
// above; out f32 [8, n]. A split takes kt rows of K (a multiple of 256; at
// most 16 splits, the blocks of one cluster), a block nt columns (32, 64,
// 128 or 256).
int perf_nibble(const void* xq, const void* x1, const void* plane,
                const void* qs, const void* smax, int k, int n, int gr,
                int kt, int nt, void* out, void* stream) {
  const int splits = kt > 0 ? (k + kt - 1) / kt : 0;
  if (k < SB || k % SB || !group_ok(gr) || kt < SB || kt % SB || n < 1 ||
      splits > NIB_MAX_SPLITS || nt < 32 || nt > 32 * NIB_WARPS ||
      (nt & (nt - 1)))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p, uintptr_t b) {
    return (reinterpret_cast<uintptr_t>(p) & (b - 1)) == 0;
  };
  const bool vec = n % 4 == 0 && aligned(plane, 16) && aligned(qs, 4) &&
                   aligned(xq, 4);
  NibArgs a;
  a.xq = (const int8_t*)xq;
  a.x1 = (const float*)x1;
  a.plane = (const uint32_t*)plane;
  a.qs = (const uint8_t*)qs;
  a.smax = (const float*)smax;
  a.k = k;
  a.n = n;
  a.units = kt / SB;
  a.warps_n = nt / 32;
  a.out = (float*)out;
  const dim3 grid((n + nt - 1) / nt, splits);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = vec ? launch_nibble_gr<true>(a, gr, grid, st)
                            : launch_nibble_gr<false>(a, gr, grid, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
