// Fused dequant-matmul for few activation rows: out[m, N] = x[m, K] @ W,
// W dequantized on the fly from the plane-packed EXL2 / GPTQ layout.
//
// Replaces: exllamav2_tpu/ops/qmm.py:_fused_segment_matmul (the Pallas kernel
// at qmm.py:512, body _dequant_block at qmm.py:110).
//
// Function (one uniform-bit segment):
//   value  q  = plane0 bits | plane1 bits << bp0, unpacked from the strided
//               sub-block layout: natural row r of a 256-row sub-block lives
//               in word (r mod Qsb) at slot (r div Qsb), Qsb = 256*bp/32;
//   weight w  = bf16(f32(q - z) * s), with
//               EXL2 prescaled:  s = scale_f[g, n] (bf16),      z = 2^(bits-1)
//               EXL2 encoded:    s = fp16(qs[g, n]^2 * smax[g]), z = 2^(bits-1)
//               EXL2 merged:     the same with smax[g, source of n]: a
//                                column-merged segment (q|k|v, gate|up) keeps
//                                one smax column per source matrix
//               GPTQ:            s = scale[g, n] (f32),          z = zero[g, n]
//   out[i, n] = sum_k f32(x[i, k]) * f32(w[k, n]), accumulated in f32.
// bf16 x bf16 products are exact in f32, so only the order of the sums can
// differ from the plain version (ops/qmm.py:qmm_plain).
//
// Bound on the H100: memory. At m <= 32 the kernel does 2*m flops for every
// 0.5-1 byte of weight it reads (bits/8 plus the group meta), far below the
// card's ~295 flop/byte ridge, so the least time is the weight bytes over
// 3.35 TB/s (4096x4096 at 4 bits, prescaled gs32: 9.4 MB -> 2.8 us). In
// practice the instructions per weight value and the fixed cost of a launch
// (first loads, the split merge) set the time, so the design spends as few
// instructions per value as it can and merges the splits in the launch.
//
// Design: bf16 tensor-core tiles for every m,
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32; A is the activation
// tile (rows past m are zero), B the dequantized weights, the sums f32 in
// registers. Two templates, chosen by m (ops/qmm.py:qmm_template):
//   * gemv (m < 8): one m16 tile whose rows 8-15 are known zero (half the A
//     registers are constant 0, only lanes of rows < m read activations);
//   * mma (8 <= m <= 32): one (m <= 16) or two full m16 tiles.
// The tensor work is free at these intensities; what the tiles buy is that
// the dequant chain is paid once per weight, not once per weight and row.
//   * B fragments straight from the plane words, no repack. Lane (g, t) of
//     a warp owns R = 2*bp0 consecutive words of each of its four columns
//     (n-tile j, mma column g is the warp's column 4g + j, so the four
//     columns of one word are a single 16-byte load): words R*t .. R*t+R-1
//     of the sub-block. Slot s of those words holds natural rows
//     Qsb*s + R*t + i (i < R), and k-step h of the slot gives the mma's k
//     indices 2t, 2t+1 rows i = 4h, 4h+1 and k indices 2t+8, 2t+9 rows
//     4h+2, 4h+3: a permutation of the rows that A follows, so the lane's
//     R activations of a slot are one contiguous (8-32 byte) load. The R
//     rows of a lane in a slot lie in one 16-row chunk, so one group scale
//     per column serves them.
//   * The dequant is done on pairs: prmt interleaves the 16-bit halves of two
//     words, so one shift and one lop3 put two values q in the two halves of
//     a register. For prescaled EXL2 (s already bf16) and bits <= 7,
//     OR 0x4300 makes bf16 (128 + q), one bf16x2 subtract of (128 + z) gives
//     q - z exactly, one bf16x2 multiply by (s, s) rounds once: the f32
//     product of two bf16 values is exact, so this is bf16(f32(q - z) * s)
//     bit for bit. The other kinds (an fp16-valued or f32 scale) and 8-bit
//     values keep the f32 product (q - z via 0x4B000000 | q, one subtract,
//     one multiply) and one cvt.rn.bf16x2.f32, as the reference rounds.
//     Plane 1 of 3/5/6 bits joins with one prmt, one rotate and one lop3
//     (row r in word r mod Q1 at slot r div Q1, Q1 = 8 or 16).
//   * Each lane issues its R (plane 0) and R (plane 1) 16-byte weight loads
//     of a sub-block at once, straight to registers; for 2- and 4-bit
//     segments below 32 rows the next sub-block's loads go out before this
//     one is computed (too many registers for the others). The sub-block's
//     activation rows and, for each 16-row chunk, its group's meta row for
//     the block's 128 columns come through a two-stage cp.async ring in
//     shared memory, also a sub-block ahead, so a lane finds its slot's
//     activations and scales at offsets fixed at compile time (meta loaded
//     per slot from device memory would chain one DRAM round trip a slot).
//   * A block is four warps, 128 columns; K is split across a thread-block
//     cluster of at most 8 blocks (grid (column blocks, splits), cluster
//     (1, splits)). Each block leaves its partial tile in shared memory, and
//     after a cluster barrier every block sums a slice of the tile over the
//     cluster's blocks in rank order through distributed shared memory and
//     writes it out: one launch, deterministic, no float atomics, no global
//     scratch (graph capture safe). Blocks of 16 (non-portable clusters) and
//     two warp groups splitting a slot's k-steps measured slower at the 7B
//     shapes.
//   * The gated entry (qmm_segment_gated) takes an int32 flag in device
//     memory, the MoE decode's "is any row routed to this expert", computed
//     on the device in the same stream (no host readback, so a CUDA graph
//     replays it). Every block reads the flag before its first load; when
//     it is 0 the split-0 block of each column block writes zeros over its
//     tile and every block returns: no plane is streamed. All blocks of a
//     cluster read the same flag and leave together, so no cluster barrier
//     waits on a block that left. Zeros, not an unwritten buffer: the
//     caller scales the output by a routing weight of 0, and 0 * NaN is NaN.
// Constraints: n % 4 == 0 and 16-byte aligned buffers (the wrapper checks),
// group sizes a multiple of 16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

enum { META_SCALE_F = 0, META_QSCALE = 1, META_GPTQ = 2, META_SRC_COLS = 3 };

struct Args {
  const __nv_bfloat16* x;
  int m, k_pad;
  const uint32_t* p0;
  const uint32_t* p1;
  int n, bits, group_rows, meta;
  const void* meta0;
  const void* meta1;
  int nsrc, src1, src2;   // META_SRC_COLS: sources, start columns of 1 and 2
  const int* gate;        // nullptr, or a flag: 0 = write zeros, load nothing
  float* out;
  int sb_per_split, nsb;
  // a pipeline stage in shared memory: activations, then the group meta of
  // each 16-row chunk of the sub-block (meta0, meta1, smax), at these byte
  // offsets; gr_shift = log2(group_rows) where that is a power of two
  int es0, es1, gr_shift, off_m0, off_m1, off_sm, stage_bytes;
};

// a lane's activations and its columns' group meta for one slot
template <int MT, int R>
struct SlotIn {
  // activation rows g, g + 8 (and g + 16, g + 24 at MT = 32): the R bf16
  // of the lane's rows in the slot
  static constexpr int XR = MT == 8 ? 1 : MT / 8;
  uint32_t x[XR][R / 2];
  uint32_t s2[4];         // prescaled path: (s, s) as bf16x2 per column
  float s[4], zc[4];      // f32 path: scale, 2^23 + zero per column
};

// per-lane pointers into stage 0 (stage 1 lies stage_bytes further): its
// first activation row g at column R*t, and its columns' meta at its chunk
// of slot 0, (R*t) / 16
struct LanePtrs {
  const unsigned char* x;
  const unsigned char* m0;
  const unsigned char* m1;
  const unsigned char* sm;
};

// the meta rows of a stage's 16 chunks: for chunk ch, the row of its group
// in a table of es bytes a column, the block's 128 columns (cut at column
// n), in P-byte pieces (P divides the table's row pitch n * es)
template <int P>
__device__ __forceinline__ void copy_meta(const Args& a, unsigned char* dst,
                                          const unsigned char* src, int es,
                                          int row0) {
  const int n0 = blockIdx.x * NB;
  const int lg = __ffs(NB * es / P) - 1;          // log2(pieces a chunk)
  const int valid = (a.n - n0) * es;              // bytes left in the row
  for (int i = threadIdx.x; i < (NCH << lg); i += THREADS) {
    const int ch = i >> lg, bo = (i & ((1 << lg) - 1)) * P;
    const int row = row0 + ch * 16;
    const int grp = a.gr_shift >= 0 ? row >> a.gr_shift : row / a.group_rows;
    const int ok = min(P, max(0, valid - bo));
    cp_piece<P>(dst + ch * NB * es + bo,
                src + ((size_t)grp * a.n + n0) * es + (ok ? bo : 0), ok);
  }
}

// one pipeline stage: the sub-block's activation rows < m and, for each
// 16-row chunk, its group's meta0 (and meta1) for the block's columns;
// smax of the chunks' groups for the EXL2 encoded kinds
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int sb) {
  const int tid = threadIdx.x;
  const __nv_bfloat16* xs = a.x + (size_t)sb * SB;
  for (int i = tid; i < a.m * (SB / 8); i += THREADS) {
    const int r = i >> 5, c = (i & 31) << 3;
    cp_piece<16>(st + (r * XSTR + c) * 2, xs + (size_t)r * a.k_pad + c, 16);
  }
  const int row0 = sb * SB;
#pragma unroll
  for (int tab = 0; tab < 2; ++tab) {
    const int es = tab ? a.es1 : a.es0;
    if (es == 0) break;
    const unsigned char* src =
        static_cast<const unsigned char*>(tab ? a.meta1 : a.meta0);
    unsigned char* dst = st + (tab ? a.off_m1 : a.off_m0);
    const int pitch = a.n * es;
    if (pitch % 16 == 0) copy_meta<16>(a, dst, src, es, row0);
    else if (pitch % 8 == 0) copy_meta<8>(a, dst, src, es, row0);
    else copy_meta<4>(a, dst, src, es, row0);
  }
  if (a.meta == META_QSCALE || a.meta == META_SRC_COLS) {
    const int ns = a.meta == META_SRC_COLS ? a.nsrc : 1;
    if (tid < NCH * ns) {
      const int ch = tid / ns, j = tid % ns;
      const int row = row0 + ch * 16;
      const int grp =
          a.gr_shift >= 0 ? row >> a.gr_shift : row / a.group_rows;
      cp_piece<4>(st + a.off_sm + (ch * 3 + j) * 4,
                  static_cast<const float*>(a.meta1) + (size_t)grp * ns + j,
                  4);
    }
  }
}

// a lane's activations and meta of slot S from the staged sub-block (rows
// Q0*S + R*t .. + R - 1 of it; chunk Q0*S/16 past the lane's own), stage at
// byte offset `off`
template <int BP0, int MT, bool FAST, int S>
__device__ __forceinline__ void read_slot(
    const Args& a, const LanePtrs& lp, int off,
    const bool (&xok)[SlotIn<MT, 2 * BP0>::XR], int c4,
    SlotIn<MT, 2 * BP0>& in) {
  constexpr int R = 2 * BP0, Q0 = 8 * BP0;
  constexpr int CH = Q0 * S / 16;
#pragma unroll
  for (int u = 0; u < SlotIn<MT, R>::XR; ++u) {
    const unsigned char* p = lp.x + off + (8 * u * XSTR + Q0 * S) * 2;
    if constexpr (R == 4) {
      const uint2 v = xok[u] ? *reinterpret_cast<const uint2*>(p)
                             : make_uint2(0, 0);
      in.x[u][0] = v.x;
      in.x[u][1] = v.y;
    } else {
#pragma unroll
      for (int q = 0; q < R / 8; ++q) {
        const uint4 v = xok[u] ? reinterpret_cast<const uint4*>(p)[q]
                               : make_uint4(0, 0, 0, 0);
        in.x[u][4 * q + 0] = v.x;
        in.x[u][4 * q + 1] = v.y;
        in.x[u][4 * q + 2] = v.z;
        in.x[u][4 * q + 3] = v.w;
      }
    }
  }
  if constexpr (FAST) {
    const uint2 v =
        *reinterpret_cast<const uint2*>(lp.m0 + off + CH * NB * 2);
    in.s2[0] = __byte_perm(v.x, v.x, 0x1010);
    in.s2[1] = __byte_perm(v.x, v.x, 0x3232);
    in.s2[2] = __byte_perm(v.y, v.y, 0x1010);
    in.s2[3] = __byte_perm(v.y, v.y, 0x3232);
  } else {
    const unsigned char* m0 = lp.m0 + off + CH * NB * a.es0;
    const float magic = 8388608.f;                  // 2^23
    float s[4], z[4];
    const float zexl2 = (float)(1 << (a.bits - 1));
    if (a.meta == META_GPTQ) {
      const float4 sv = *reinterpret_cast<const float4*>(m0);
      const int4 zv =
          *reinterpret_cast<const int4*>(lp.m1 + off + CH * NB * 4);
      s[0] = sv.x; s[1] = sv.y; s[2] = sv.z; s[3] = sv.w;
      z[0] = (float)zv.x; z[1] = (float)zv.y;
      z[2] = (float)zv.z; z[3] = (float)zv.w;
    } else if (a.meta == META_SCALE_F) {
      const uint2 v = *reinterpret_cast<const uint2*>(m0);
      s[0] = __uint_as_float(v.x << 16);
      s[1] = __uint_as_float(v.x & 0xffff0000u);
      s[2] = __uint_as_float(v.y << 16);
      s[3] = __uint_as_float(v.y & 0xffff0000u);
#pragma unroll
      for (int j = 0; j < 4; ++j) z[j] = zexl2;
    } else {
      const uchar4 qv = *reinterpret_cast<const uchar4*>(m0);
      const float* smax =
          reinterpret_cast<const float*>(lp.sm + off) + CH * 3;
      const int qs[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // merged segment: one smax per source; src2 == n with two sources
        const int col = c4 + j;
        const float sm = a.meta == META_SRC_COLS
            ? smax[(col >= a.src1) + (col >= a.src2)] : smax[0];
        s[j] = __half2float(__float2half_rn((float)(qs[j] * qs[j]) * sm));
        z[j] = zexl2;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in.s[j] = s[j];
      in.zc[j] = magic + z[j];
    }
  }
}

// The B register of two rows (the halves of the result) of column j: plane-0
// words a, b at slot S; plane-1 words a1, b1 selected by sel1 and rotated
// by rot1 into bits bp0 .. bp0 + bp1 - 1
template <int BP0, int BP1, int S, bool FAST, int MT, int R>
__device__ __forceinline__ uint32_t deq(uint32_t wa, uint32_t wb,
                                        uint32_t w1a, uint32_t w1b,
                                        uint32_t sel1, int rot1, uint32_t zc2,
                                        const SlotIn<MT, R>& in, int j) {
  // FAST: bf16 (128 + q) in each half; else the bare values
  const uint32_t q = pair_bits<BP0, BP1, S>(wa, wb, w1a, w1b, sel1, rot1,
                                            FAST ? 0x43004300u : 0u);
  if constexpr (FAST) {
    // (128 + q) - (128 + z) is exact; the multiply rounds the exact
    // product once
    const __nv_bfloat162 d = __hsub2(bits_bf2(q), bits_bf2(zc2));
    return bf2_bits(__hmul2(d, bits_bf2(in.s2[j])));
  } else {
    // f32 (2^23 + q) in each half; less 2^23 + z is q - z exactly
    const uint32_t mg = 0x4b000000u;
    const float lo = __uint_as_float(__byte_perm(q, mg, 0x7610));
    const float hi = __uint_as_float(__byte_perm(q, mg, 0x7632));
    const float wl = __fmul_rn(__fsub_rn(lo, in.zc[j]), in.s[j]);
    const float wh = __fmul_rn(__fsub_rn(hi, in.zc[j]), in.s[j]);
    return bf2_bits(__floats2bfloat162_rn(wl, wh));
  }
}

template <int BP0, int BP1, int MT, bool FAST, int S>
__device__ __forceinline__ void slot_mma(
    const Words<BP0, BP1>& w, const SlotIn<MT, 2 * BP0>& in,
    int t, uint32_t zc2, float (&acc)[MT == 32 ? 2 : 1][4][4]) {
  constexpr int MTL = MT == 32 ? 2 : 1;
  uint32_t sel1;
  int rot1;
  plane1_shift<BP0, BP1, S>(t, sel1, rot1);
  // k-step h of the slot: the lane's words 4h .. 4h + 3
#pragma unroll
  for (int h = 0; h < BP0 / 2; ++h) {
    uint32_t af[MTL][4];
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt) {
      af[mt][0] = in.x[2 * mt][2 * h];
      af[mt][2] = in.x[2 * mt][2 * h + 1];
      if constexpr (MT == 8) {
        af[mt][1] = 0u;
        af[mt][3] = 0u;
      } else {
        af[mt][1] = in.x[2 * mt + 1][2 * h];
        af[mt][3] = in.x[2 * mt + 1][2 * h + 1];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * h;
      const uint32_t b0 = deq<BP0, BP1, S, FAST>(
          comp(w.w0[i], j), comp(w.w0[i + 1], j),
          BP1 ? comp(w.w1[BP1 ? i : 0], j) : 0u,
          BP1 ? comp(w.w1[BP1 ? i + 1 : 0], j) : 0u, sel1, rot1, zc2, in, j);
      const uint32_t b1 = deq<BP0, BP1, S, FAST>(
          comp(w.w0[i + 2], j), comp(w.w0[i + 3], j),
          BP1 ? comp(w.w1[BP1 ? i + 2 : 0], j) : 0u,
          BP1 ? comp(w.w1[BP1 ? i + 3 : 0], j) : 0u, sel1, rot1, zc2, in, j);
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) mma_bf16(acc[mt][j], af[mt], b0, b1);
    }
  }
}

// the slots S .. PER0 - 1 of one sub-block
template <int BP0, int BP1, int MT, bool FAST, int S>
__device__ __forceinline__ void run_slots(
    const Args& a, const LanePtrs& lp, int off,
    const bool (&xok)[SlotIn<MT, 2 * BP0>::XR], int t, int c4,
    uint32_t zc2, const Words<BP0, BP1>& w,
    float (&acc)[MT == 32 ? 2 : 1][4][4]) {
  if constexpr (S < 32 / BP0) {
    SlotIn<MT, 2 * BP0> in;
    read_slot<BP0, MT, FAST, S>(a, lp, off, xok, c4, in);
    slot_mma<BP0, BP1, MT, FAST, S>(w, in, t, zc2, acc);
    run_slots<BP0, BP1, MT, FAST, S + 1>(a, lp, off, xok, t, c4, zc2, w,
                                         acc);
  }
}

// blocks per SM the register budget is cut for
__host__ __device__ constexpr int min_blocks(int mt) {
  return mt == 32 ? 2 : mt == 16 ? 3 : 4;
}

template <int BP0, int BP1, int MT, bool FAST>
__global__ void __launch_bounds__(THREADS, min_blocks(MT))
    qmm_kernel(const Args a) {
  constexpr int R = 2 * BP0;
  constexpr int MTL = MT == 32 ? 2 : 1;
  constexpr int XR = SlotIn<MT, R>::XR;
  // the next sub-block's words are loaded ahead where registers allow
  constexpr bool AHEAD = BP1 == 0 && BP0 <= 4 && MT <= 16;
  static_assert(BP1 == 0 || 8 * BP1 % R == 0, "plane-1 words of a lane");
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NB;
  const int cw4 = warp * 32 + 4 * g;               // the lane's four columns
  const int c4 = n0 + cw4;
  const bool live = c4 < a.n;
  if (a.gate != nullptr && *a.gate == 0) {
    if (blockIdx.y == 0)
      for (int e = threadIdx.x; e < a.m * (NB / 4); e += THREADS) {
        const int row = e / (NB / 4), cc = (e % (NB / 4)) * 4;
        if (n0 + cc < a.n)
          *reinterpret_cast<float4*>(a.out + (size_t)row * a.n + n0 + cc) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    return;
  }
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);
  const float zf = (float)(128 + (1 << (a.bits - 1)));
  const uint32_t zc2 = bf2_bits(__floats2bfloat162_rn(zf, zf));
  const int ch0 = (R * t) / 16;                    // the lane's chunk at S = 0
  LanePtrs lp;
  lp.x = smem + (g * XSTR + R * t) * 2;
  lp.m0 = smem + a.off_m0 + (ch0 * NB + cw4) * a.es0;
  lp.m1 = smem + a.off_m1 + (ch0 * NB + cw4) * 4;
  lp.sm = smem + a.off_sm + ch0 * 3 * 4;
  bool xok[XR];
#pragma unroll
  for (int u = 0; u < XR; ++u) xok[u] = g + 8 * u < a.m;

  float acc[MTL][4][4];
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;

  Words<BP0, BP1> w;
  if (sb0 < sb1) {
    load_words<BP0, BP1>(a.p0, a.p1, a.n, sb0, t, c4, live, w);
    load_stage(a, smem, sb0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int sb = sb0, off = 0; sb < sb1;
       ++sb, off = a.stage_bytes - off) {
    Words<BP0, BP1> nw;
    if (sb + 1 < sb1) {
      load_stage(a, smem + (a.stage_bytes - off), sb + 1);
      if constexpr (AHEAD)
        load_words<BP0, BP1>(a.p0, a.p1, a.n, sb + 1, t, c4, live, nw);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    run_slots<BP0, BP1, MT, FAST, 0>(a, lp, off, xok, t, c4, zc2, w, acc);
    __syncthreads();                    // the stage is overwritten next
    if constexpr (AHEAD) {
      w = nw;
    } else {
      if (sb + 1 < sb1)
        load_words<BP0, BP1>(a.p0, a.p1, a.n, sb + 1, t, c4, live, w);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // lane register r of n-tile j: row 16mt + g + 8(r >> 1), the warp's
  // column 8t + 4(r & 1) + j
  const int cw = warp * 32 + 8 * t;
  float* red = reinterpret_cast<float*>(smem);     // [MT][NB], stage 0
  if (gridDim.y == 1) {
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = 16 * mt + g + 8 * e, col = n0 + cw + 4 * hh;
          const int r = 2 * e + hh;
          if (row < a.m && col < a.n)
            *reinterpret_cast<float4*>(a.out + (size_t)row * a.n + col) =
                make_float4(acc[mt][0][r], acc[mt][1][r], acc[mt][2][r],
                            acc[mt][3][r]);
        }
    return;
  }

  // K split over the cluster: partial tiles in shared memory (stage 0, free
  // now), each block sums a slice of the tile over the blocks in rank order
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * mt + g + 8 * e;
        const int r = 2 * e + hh;
        if (row < MT && row < a.m)
          *reinterpret_cast<float4*>(&red[row * NB + cw + 4 * hh]) =
              make_float4(acc[mt][0][r], acc[mt][1][r], acc[mt][2][r],
                          acc[mt][3][r]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)gridDim.y;
  const int rank = (int)cluster.block_rank();
  const int chunks = a.m * (NB / 4);
  for (int e = rank * THREADS + threadIdx.x; e < chunks;
       e += splits * THREADS) {
    const int row = e / (NB / 4), cc = (e % (NB / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(&red[row * NB + cc], q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (n0 + cc < a.n)
      *reinterpret_cast<float4*>(a.out + (size_t)row * a.n + n0 + cc) = s;
  }
  cluster.sync();               // no block leaves while others read its tile
}

// the largest two-stage ring of an m-tile: the activation rows, then GPTQ
// meta (two 4-byte values a column) and smax for each of the 16 chunks
constexpr int max_ring(int mt) {
  return 2 * (mt * XSTR * 2 + 2 * NCH * NB * 4 + NCH * 3 * 4);
}

template <int BP0, int BP1, int MT, bool FAST>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  const int bytes = 2 * a.stage_bytes;
  static bool opted_in = false;          // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_kernel<BP0, BP1, MT, FAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_ring(MT));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (bytes > max_ring(MT)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_kernel<BP0, BP1, MT, FAST>, a);
}

template <int BP0, int BP1, bool FAST>
cudaError_t launch_mt(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.m < 8) return launch<BP0, BP1, 8, FAST>(a, grid, st);
  if (a.m <= 16) return launch<BP0, BP1, 16, FAST>(a, grid, st);
  return launch<BP0, BP1, 32, FAST>(a, grid, st);
}

template <int BP0, int BP1>
cudaError_t launch_kind(const Args& a, dim3 grid, cudaStream_t st) {
  if constexpr (BP0 + BP1 <= 7) {
    if (a.meta == META_SCALE_F) return launch_mt<BP0, BP1, true>(a, grid, st);
  }
  return launch_mt<BP0, BP1, false>(a, grid, st);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"

namespace {

int segment(const void* x, int m, int k_pad, const void* plane0,
            const void* plane1, int bp0, int bp1, int n, int bits,
            int group_rows, int meta, const void* meta0, const void* meta1,
            int nsrc, int src1, int src2, void* out, int splits,
            int sb_per_split, const void* gate, void* stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (m < 1 || m > 32 || k_pad % SB || group_rows < 16 || group_rows % 16 ||
      n % 4 || splits < 1 || splits > MAX_SPLITS || sb_per_split < 1 ||
      bits != bp0 + bp1)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(plane0) || (bp1 && !aligned(plane1)) ||
      !aligned(meta0) || !aligned(meta1) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  if (meta == META_SRC_COLS && (nsrc < 2 || nsrc > 3 || src1 > src2))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.m = m;
  a.k_pad = k_pad;
  a.p0 = (const uint32_t*)plane0;
  a.p1 = (const uint32_t*)plane1;
  a.n = n;
  a.bits = bits;
  a.group_rows = group_rows;
  a.meta = meta;
  a.meta0 = meta0;
  a.meta1 = meta1;
  a.nsrc = nsrc;
  a.src1 = src1;
  a.src2 = src2;
  a.gate = (const int*)gate;
  a.out = (float*)out;
  a.sb_per_split = sb_per_split;
  a.nsb = k_pad / SB;
  // the stage: activation rows of the m16 tiles, then the meta of the 16
  // chunks (16-byte aligned sections)
  const int mt = m < 8 ? 8 : m <= 16 ? 16 : 32;
  a.es0 = meta == META_GPTQ ? 4 : meta == META_SCALE_F ? 2 : 1;
  a.es1 = meta == META_GPTQ ? 4 : 0;
  a.gr_shift =
      (group_rows & (group_rows - 1)) ? -1 : __builtin_ctz(group_rows);
  a.off_m0 = mt * XSTR * 2;
  a.off_m1 = a.off_m0 + NCH * NB * a.es0;
  a.off_sm = a.off_m1 + NCH * NB * a.es1;
  a.stage_bytes = a.off_sm + NCH * 3 * 4;
  if ((a.nsb + sb_per_split - 1) / sb_per_split != splits)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + NB - 1) / NB, splits);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (bp0 * 10 + bp1) {
    case 20: e = launch_kind<2, 0>(a, grid, st); break;
    case 40: e = launch_kind<4, 0>(a, grid, st); break;
    case 80: e = launch_kind<8, 0>(a, grid, st); break;
    case 21: e = launch_kind<2, 1>(a, grid, st); break;
    case 41: e = launch_kind<4, 1>(a, grid, st); break;
    case 42: e = launch_kind<4, 2>(a, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, k_pad] bf16; planes int32/uint32 [k_pad*bp/32, n]; meta as in
// read_slot (nsrc, src1, src2 are read for META_SRC_COLS only); out [m, n]
// f32. splits <= 8 blocks of one cluster share a column block, each
// sb_per_split sub-blocks of K. n % 4 == 0, buffers 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
int qmm_segment(const void* x, int m, int k_pad,
                const void* plane0, const void* plane1, int bp0, int bp1,
                int n, int bits, int group_rows, int meta,
                const void* meta0, const void* meta1,
                int nsrc, int src1, int src2,
                void* out, int splits, int sb_per_split, void* stream) {
  return segment(x, m, k_pad, plane0, plane1, bp0, bp1, n, bits, group_rows,
                 meta, meta0, meta1, nsrc, src1, src2, out, splits,
                 sb_per_split, nullptr, stream);
}

// qmm_segment with a gate: an int32 flag in device memory (read by the
// kernel when it runs); 0 makes out zeros and streams no planes.
int qmm_segment_gated(const void* x, int m, int k_pad,
                      const void* plane0, const void* plane1, int bp0,
                      int bp1, int n, int bits, int group_rows, int meta,
                      const void* meta0, const void* meta1,
                      int nsrc, int src1, int src2,
                      void* out, int splits, int sb_per_split,
                      const void* gate, void* stream) {
  if (gate == nullptr) return (int)cudaErrorInvalidValue;
  return segment(x, m, k_pad, plane0, plane1, bp0, bp1, n, bits, group_rows,
                 meta, meta0, meta1, nsrc, src1, src2, out, splits,
                 sb_per_split, gate, stream);
}

}  // extern "C"
