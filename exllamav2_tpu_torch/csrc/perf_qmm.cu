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
//    Design: the nibble kernel's (3. below) carried to the strided layout,
//    one template gp_kernel<BP, INT8, GR, VEC> for both modes, every width
//    and group size, and aligned (VEC) or word-by-word loads.
//    The weights are A of mma.sync (16 output columns), the 8 activation
//    rows B: int8 m16n8k32 (int32 tile) or bf16 m16n8k16 (f32 tile).
//    THE K MAP: k-step s of a unit covers rows 32s .. 32s+31 and lane (g, t)
//    feeds k = 4t..4t+3 from rows 32s+4t+i and k = 16+4t.. from rows
//    32s+16+4t+i (i = 0..3), the natural order, so B is xq or x as it lies
//    in memory and a k-step (a k16 step for bf16) never leaves its group
//    for gr >= 32 (gr >= 16). Rows 4q..4q+3 are one slot of four
//    consecutive words, word 4 (q mod 2 bits) + i at slot q div (2 bits):
//    a lane loads runs of four words of its four columns, one uint4 a
//    word (bits 4: words 4t.. and 16+4t..; 8: four runs 16r+4t..; 2: one
//    run 4t..; 1: words 4(t&1).. shifted right by t>>1, two lanes a run),
//    takes the byte that holds a slot from each of the four words with three
//    prmt (a 4x4 byte transpose of the raw words, shared by the four bytes)
//    and the slot from that register with one shift and one mask (shared
//    by the 8 / bits slots of a byte): one register of four k-consecutive
//    values of one group. int8 mode uses it as is (an 8-bit value wraps, as
//    the cast does); bf16 mode ORs 0x43 above each value with one prmt per two
//    (bf16 128 + q) and subtracts 136 in bf16x2, exact below 8 bits; 8-bit
//    values go through f32 (2^23 + q less 2^23 + 8) and one cvt. The group
//    sums of xq in int8 mode are an mma of the same B against ones. Groups
//    of 16 in int8 mode take one mma a group with the other group's B
//    zeroed. Per group the epilogue adds (f32(p) - 8 x1) * s (int8) or
//    p * s (bf16) to an f32 sum in group order with the non-contracting
//    intrinsics, so only the order of the f32 sums differs from the plain
//    version. GR and VEC are template parameters, so where a group starts
//    and ends and how the words load are fixed in the unrolled unit (the
//    same code with a runtime group size measured 1.4-1.6x slower on the
//    H100). Blocks, the split picker (tools/perf_qmm.nibble_tiles), the loads
//    of a unit issued together and the cluster sum are the nibble kernel's:
//    one launch, no global scratch.
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
// Later work: the plane through TMA bulk copies into a shared-memory ring
// (what lifted csrc/paged_attn.cu), for all three.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MROWS = 8;
constexpr int SB = 256;
constexpr int MIN_GROUP = 16;

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

// The block's f32 sums into out [8, n]. Lane (g, t) of warp (wn, wk) holds
// acc[cc][mm], column n0 + 32 wn + 4g + cc, activation row 2t + mm. The
// partial tiles red[wk][m][nt] of the K warps are summed in order into
// blk[m][nt], then the blocks' blk in rank order, every rank's value of an
// element loaded before the first add (one round trip of distributed
// shared memory, not a chain of them).
__device__ __forceinline__ void cluster_sum_store(
    const float (&acc)[4][2], float* red, float* blk, int wk, int wn,
    int warps_k, int nt, int n0, int n, float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
    if (n0 + cc < n) out[(size_t)m * n + n0 + cc] = s;
  }
  if (splits > 1) cluster.sync();   // no block leaves while others read it
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

  cluster_sum_store(acc, red, blk, wk, wn, warps_k, nt, n0, a.n, a.out);
}

// ---- gp: group partials on tensor-core fragments (design: 2. above)

struct GpArgs {
  const void* x;            // [8, k] bf16 or int8, 16-byte aligned
  const uint32_t* plane;    // [k * bits / 32, n]
  const uint8_t* qs;        // [k / gr, n]
  const float* smax;        // [k / gr]
  int k, n, gr;
  int units;                // 256-row units a split takes
  int warps_n;              // warps across the block's 32 * warps_n columns
  float* out;               // [8, n]
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t col_of(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// byte b of each of four words, word i in byte i: a 4x4 byte transpose
// whose first two prmt serve two values of b (b, like every index of the
// maps below, is a constant once the k-step loop is unrolled)
__device__ __forceinline__ uint32_t byte_of4(uint32_t m0, uint32_t m1,
                                             uint32_t m2, uint32_t m3,
                                             int b) {
  const uint32_t pair = b < 2 ? 0x5140u : 0x7362u;
  const uint32_t x01 = __byte_perm(m0, m1, pair);
  const uint32_t x23 = __byte_perm(m2, m3, pair);
  return __byte_perm(x01, x23, (b & 1) ? 0x7632u : 0x5410u);
}

template <int BP>
struct GpMap {
  static constexpr int QSB = 8 * BP;                  // words a sub-block
  static constexpr int RUNS = BP >= 2 ? BP / 2 : 1;   // four-word runs a lane
  static constexpr uint32_t FIELD =
      BP == 8 ? 0xFFFFFFFFu : ((1u << BP) - 1u) * 0x01010101u;
};

// the values of rows 32s + 16h + 4t + i (i = 0..3) of column c as the bytes
// of one register: slot j of the lane's run r (THE K MAP). The raw bytes
// that hold the slot are transposed first, so one shift and one mask on the
// register take the slot (the 8 / bits slots of a byte share a transpose).
template <int BP>
__device__ __forceinline__ uint32_t slot_values(
    const uint4 (&w)[GpMap<BP>::RUNS][4], int s, int h, int c) {
  const int r = BP == 1 ? 0 : ((8 * s + 4 * h) % (2 * BP)) / 4;
  const int j = BP == 1 ? 4 * s + 2 * h : (8 * s + 4 * h) / (2 * BP);
  const uint32_t raw = byte_of4(col_of(w[r][0], c), col_of(w[r][1], c),
                                col_of(w[r][2], c), col_of(w[r][3], c),
                                (BP * j) / 8);
  return (raw >> ((BP * j) % 8)) & GpMap<BP>::FIELD;
}

// bytes 2p, 2p+1 of v (values q) as bf16x2 q - 8, exact
template <int BP>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t v, int p) {
  if constexpr (BP == 8) {
    // 2^23 + q as f32 less 2^23 + 8: a q above 127 has no room in bf16's 7
    // mantissa bits above 128, but q - 8 (-8 .. 247) is exact in bf16
    const float f0 = __fsub_rn(
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u + 2 * p)),
        8388616.f);
    const float f1 = __fsub_rn(
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7441u + 2 * p)),
        8388616.f);
    return bf2_bits(__floats2bfloat162_rn(f0, f1));
  } else {
    // 0x43 above each value: bf16 128 + q, less bf16x2 136
    const uint32_t h = __byte_perm(v, 0x43u, p == 0 ? 0x4140u : 0x4342u);
    return bf2_bits(__hsub2(bits_bf2(h), bits_bf2(0x43084308u)));
  }
}

// one group's f32 tile into the f32 sums (bf16 mode): C register 2e + mm of
// column pair p is column 4g + 2p + e, activation row 2t + mm
__device__ __forceinline__ void gp_epilogue(float (&acc)[4][2],
                                            const float (&c)[2][4],
                                            uint32_t q4, float sm) {
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const float s = exl2_scale((q4 >> (8 * cc)) & 0xFF, sm);
    const float* v = &c[cc >> 1][2 * (cc & 1)];
    acc[cc][0] = __fadd_rn(acc[cc][0], __fmul_rn(v[0], s));
    acc[cc][1] = __fadd_rn(acc[cc][1], __fmul_rn(v[1], s));
  }
}

// one group's int32 tile and its ones-tile (the group sums of xq for rows
// 2t, 2t+1) into the f32 sums (int8 mode)
__device__ __forceinline__ void gp_epilogue(float (&acc)[4][2],
                                            const int (&c)[2][4],
                                            const int (&cx)[4], uint32_t q4,
                                            float sm) {
  nib_epilogue(acc, c, q4, sm, __fmul_rn(8.f, (float)cx[0]),
               __fmul_rn(8.f, (float)cx[1]));
}

// a unit's plane words of the lane: run r is words 16r + 4t .. +3 (bits 1:
// words 4(t&1) .. +3, shifted right by t>>1) of columns col .. col+3
template <int BP, bool VEC>
__device__ __forceinline__ void gp_words(uint4 (&w)[GpMap<BP>::RUNS][4],
                                         const uint32_t* plane, int u,
                                         int t, int col, int n) {
  const int w0 = BP == 1 ? 4 * (t & 1) : 4 * t;
#pragma unroll
  for (int r = 0; r < GpMap<BP>::RUNS; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[r][i] = words4<VEC>(
          plane + ((size_t)u * GpMap<BP>::QSB + 16 * r + w0 + i) * n, col,
          n);
  if constexpr (BP == 1) {
    const int sh = t >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[0][i].x >>= sh;
      w[0][i].y >>= sh;
      w[0][i].z >>= sh;
      w[0][i].w >>= sh;
    }
  }
}

template <int BP, bool INT8, int GR, bool VEC>
__global__ void __launch_bounds__(NIB_THREADS, BP == 8 ? 1 : 2)
gp_kernel(const GpArgs a) {
  constexpr int RUNS = GpMap<BP>::RUNS;
  constexpr int NG = SB / GR;                 // groups a unit
  constexpr int SPG = GR >= 32 ? GR / 32 : 1;  // k-steps a group
  constexpr uint32_t ONES = 0x01010101u;
  __shared__ float red[NIB_WARPS * 32 * MROWS];     // [K warp][8][nt]
  __shared__ float blk[MROWS * 32 * NIB_WARPS];      // [8][nt], nt <= 256
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % a.warps_n, wk = warp / a.warps_n;
  const int warps_k = NIB_WARPS / a.warps_n;
  const int nt = 32 * a.warps_n;
  const int n0 = blockIdx.x * nt;
  const int col = n0 + wn * 32 + 4 * g;       // the lane's four columns
  const int u1 = min((int)(blockIdx.y + 1) * a.units, a.k / SB);
  // B column g: row g of x, from the lane's first row 4t of a k-step
  const char* xrow = static_cast<const char*>(a.x) +
                     ((size_t)g * a.k + 4 * t) * (INT8 ? 1 : 2);

  float acc[4][2];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) acc[cc][0] = acc[cc][1] = 0.f;

  for (int u = blockIdx.y * a.units + wk; u < u1; u += warps_k) {
    // every load of the unit first: the plane words, B of each k-step, the
    // scales of each group
    uint4 w[RUNS][4];
    gp_words<BP, VEC>(w, a.plane, u, t, col, a.n);
    const char* xu = xrow + (size_t)u * SB * (INT8 ? 1 : 2);
    uint32_t b[NIB_STEPS][2][INT8 ? 1 : 2];   // [step][half][register]
#pragma unroll
    for (int s = 0; s < NIB_STEPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (INT8) {
          b[s][h][0] = __ldg(reinterpret_cast<const uint32_t*>(
              xu + 32 * s + 16 * h));
        } else {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(
              xu + 2 * (32 * s + 16 * h)));
          b[s][h][0] = v.x;
          b[s][h][1] = v.y;
        }
      }
    uint32_t q[NG];
    float sm[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int grp = u * NG + i;
      q[i] = bytes4<VEC>(a.qs + (size_t)grp * a.n, col, a.n);
      sm[i] = __ldg(a.smax + grp);
    }

    if constexpr (INT8) {
      // a group's int32 tile and its ones-tile (the group sums of xq)
      int ci[2][4], cx[4];
#pragma unroll
      for (int s = 0; s < NIB_STEPS; ++s)
#pragma unroll
        for (int hh = 0; hh < (GR == 16 ? 2 : 1); ++hh) {
          // the whole k-step, or (groups of 16) one half with the other
          // half's B zeroed
          const uint32_t b0 = GR == 16 && hh == 1 ? 0u : b[s][0][0];
          const uint32_t b1 = GR == 16 && hh == 0 ? 0u : b[s][1][0];
          if (GR == 16 || s % SPG == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) ci[0][i] = ci[1][i] = cx[i] = 0;
          }
#pragma unroll
          for (int p = 0; p < 2; ++p)
            mma_s8(ci[p], slot_values<BP>(w, s, 0, 2 * p),
                   slot_values<BP>(w, s, 0, 2 * p + 1),
                   slot_values<BP>(w, s, 1, 2 * p),
                   slot_values<BP>(w, s, 1, 2 * p + 1), b0, b1);
          mma_s8(cx, ONES, ONES, ONES, ONES, b0, b1);
          if (GR == 16)
            gp_epilogue(acc, ci, cx, q[2 * s + hh], sm[2 * s + hh]);
          else if ((s + 1) % SPG == 0)
            gp_epilogue(acc, ci, cx, q[s / SPG], sm[s / SPG]);
        }
    } else {
      float cf[2][4];                         // a group's f32 tile
#pragma unroll
      for (int s = 0; s < NIB_STEPS; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (GR == 16 || (h == 0 && s % SPG == 0)) {
#pragma unroll
            for (int i = 0; i < 4; ++i) cf[0][i] = cf[1][i] = 0.f;
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const uint32_t v0 = slot_values<BP>(w, s, h, 2 * p);
            const uint32_t v1 = slot_values<BP>(w, s, h, 2 * p + 1);
            // k 2t, 2t+1 are rows 4t, 4t+1 of the half; k 2t+8, 2t+9 rows
            // 4t+2, 4t+3
            mma_bf16(cf[p], bf16_pair<BP>(v0, 0), bf16_pair<BP>(v1, 0),
                     bf16_pair<BP>(v0, 1), bf16_pair<BP>(v1, 1), b[s][h][0],
                     b[s][h][1]);
          }
          if (GR == 16) gp_epilogue(acc, cf, q[2 * s + h], sm[2 * s + h]);
          else if (h == 1 && (s + 1) % SPG == 0)
            gp_epilogue(acc, cf, q[s / SPG], sm[s / SPG]);
        }
    }
  }
  cluster_sum_store(acc, red, blk, wk, wn, warps_k, nt, n0, a.n, a.out);
}

// one launch of KERNEL over grid (column blocks, splits), the splits of a
// column block one thread-block cluster (up to 16: a non-portable size)
template <auto KERNEL, typename ARGS>
cudaError_t launch_split(const ARGS& a, dim3 grid, cudaStream_t st) {
  static bool configured = false;             // opt in once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
  return cudaLaunchKernelEx(&cfg, KERNEL, a);
}

template <int GR, bool VEC>
cudaError_t launch_nibble(const NibArgs& a, dim3 grid, cudaStream_t st) {
  return launch_split<nibble_kernel<GR, VEC>>(a, grid, st);
}

template <int BP, bool INT8, bool VEC>
cudaError_t launch_gp(const GpArgs& a, dim3 grid, cudaStream_t st) {
  switch (a.gr) {
    case 16: return launch_split<gp_kernel<BP, INT8, 16, VEC>>(a, grid, st);
    case 32: return launch_split<gp_kernel<BP, INT8, 32, VEC>>(a, grid, st);
    case 64: return launch_split<gp_kernel<BP, INT8, 64, VEC>>(a, grid, st);
    case 128: return launch_split<gp_kernel<BP, INT8, 128, VEC>>(a, grid, st);
    case 256: return launch_split<gp_kernel<BP, INT8, 256, VEC>>(a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int BP>
cudaError_t launch_gp_mode(const GpArgs& a, bool int8, bool vec, dim3 grid,
                           cudaStream_t st) {
  if (vec)
    return int8 ? launch_gp<BP, true, true>(a, grid, st)
                : launch_gp<BP, false, true>(a, grid, st);
  return int8 ? launch_gp<BP, true, false>(a, grid, st)
              : launch_gp<BP, false, false>(a, grid, st);
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

bool group_ok(int gr) {
  return gr >= MIN_GROUP && gr <= SB && (gr & (gr - 1)) == 0;
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

// x [8, k] bf16 (int8_mode 0) or int8 (1), 16-byte aligned; plane
// [k*bits/32, n]; qs uint8 [k/gr, n]; smax f32 [k/gr]; out f32 [8, n].
// k % 256 == 0, gr a power of two in [16, 256]. A split takes kt rows of K
// (a multiple of 256; at most 16 splits, the blocks of one cluster), a
// block nt columns (32, 64, 128 or 256).
int perf_gp(const void* x, const void* plane, const void* qs,
            const void* smax, int k, int n, int bits, int gr, int int8_mode,
            int kt, int nt, void* out, void* stream) {
  const int splits = kt > 0 ? (k + kt - 1) / kt : 0;
  if (k < SB || k % SB || !group_ok(gr) || kt < SB || kt % SB || n < 1 ||
      splits > NIB_MAX_SPLITS || nt < 32 || nt > 32 * NIB_WARPS ||
      (nt & (nt - 1)) || (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p, uintptr_t b) {
    return (reinterpret_cast<uintptr_t>(p) & (b - 1)) == 0;
  };
  GpArgs a;
  a.x = x;
  a.plane = (const uint32_t*)plane;
  a.qs = (const uint8_t*)qs;
  a.smax = (const float*)smax;
  a.k = k;
  a.n = n;
  a.gr = gr;
  a.units = kt / SB;
  a.warps_n = nt / 32;
  a.out = (float*)out;
  const dim3 grid((n + nt - 1) / nt, splits);
  cudaStream_t st = (cudaStream_t)stream;
  const bool int8 = int8_mode != 0;
  const bool vec = n % 4 == 0 && aligned(plane, 16) && aligned(qs, 4);
  cudaError_t e;
  switch (bits) {
    case 1: e = launch_gp_mode<1>(a, int8, vec, grid, st); break;
    case 2: e = launch_gp_mode<2>(a, int8, vec, grid, st); break;
    case 4: e = launch_gp_mode<4>(a, int8, vec, grid, st); break;
    case 8: e = launch_gp_mode<8>(a, int8, vec, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
