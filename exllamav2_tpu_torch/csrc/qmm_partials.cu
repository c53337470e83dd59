// GPTQ scales-on-partials matmul for few activation rows (exact):
//   out[m, N] = sum_g s_g * (x_g @ v_g - z_g * sum(x_g)),
// the dequant-matmul x @ ((v - z) * s) with scale and zero moved from every
// weight value to the per-group partial sums.
//
// Replaces: exllamav2_tpu/ops/qmm.py:_partials_gptq_matmul (the Pallas
// kernel at qmm.py:225). Serves GPTQ segments with groups of >= 128 rows
// when QMM_PARTIALS=1 (ops/qmm.py:_use_partials).
//
// Function (groups of gr rows): per group g and token i,
//   pg = sum_r f32(x[i, r]) * v[r, n]  (a bf16 times an integer <= 255 is
//        exact in f32, the sum is f32);
//   xs = sum_r f32(x[i, r]);
//   out[i, n] = sum_g (pg - xs * z[g, n]) * s[g, n]   (f32 s, integer z).
// Kernel and plain version (ops/qmm.py:qmm_partials_plain) differ in the
// order of the f32 sums only. Against the fused dequant-matmul (qmm.cu) the
// result differs by that kernel's bf16 rounding of each weight.
//
// Bound on the H100: memory, as for qmm.cu: the weight and meta bytes over
// 3.35 TB/s.
//
// Design: kernel 1's bf16 tensor-core tile (csrc/qmm_tile.cuh), one launch.
//   * B fragments straight from the plane words with kernel 1's lane map;
//     the dequant is only the exact integer: for <= 7 bits one lop3 ORs
//     0x4300 into each half (bf16 128 + q) and one bf16x2 subtract of
//     (128, 128) leaves q; 8-bit values go through f32 (2^23 + q by a prmt,
//     less 2^23) and one cvt.rn.bf16x2.f32, exact because q <= 255 has 8
//     significant bits. mma.sync.m16n8k16 (bf16 x bf16, f32 accumulate)
//     sums the group partials pg in registers.
//   * xs in the same tile: one more mma a k-step whose B is all ones
//     (bf16 1.0) sums the staged activations of the lane's token rows in
//     f32, so every lane holds xs for the rows of its accumulators.
//   * A slot covers Qsb = 8*bp0 consecutive rows (16 / 32 / 64), which
//     divides every group size served (128, or a multiple of 256), so a
//     group ends on a slot boundary; there the epilogue adds
//     (pg - xs*z)*s into a running f32 tile (f32 multiply, subtract,
//     multiply, add, as the plain version rounds) and clears pg and xs.
//     Scale and zero of the ending groups for the block's 128 columns ride
//     in the cp.async stage with the sub-block's activations.
//   * K is split across a thread-block cluster of at most 8 blocks, each
//     split a whole number of groups; the partial tiles are summed in rank
//     order through distributed shared memory: one device kernel a call,
//     deterministic, no global scratch.
// Constraints: n % 4 == 0 and 16-byte aligned buffers (the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t ONES = 0x3F803F80u;     // bf16x2 (1.0, 1.0)

struct Args {
  const __nv_bfloat16* x;   // [m, k_pad]
  int m, k_pad;
  const uint32_t* p0;
  const uint32_t* p1;
  int n, group_rows;
  const float* scale;       // [groups, n]
  const int* zero;          // [groups, n]
  float* out;               // [m, n]
  int sb_per_split, nsb;
  // a stage: activation rows, then at off_meta the scale rows and at
  // off_meta + nme*NB*4 the zero rows of the nme groups that end in the
  // sub-block (nme = 2 for groups of 128 rows, else 1)
  int nme, off_meta, stage_bytes;
};

// one pipeline stage: the sub-block's activation rows < m, and the scale
// and zero rows of its groups for the block's columns (cut at column n)
__device__ __forceinline__ void load_stage(const Args& a, unsigned char* st,
                                           int sb) {
  const int tid = threadIdx.x;
  const __nv_bfloat16* xs = a.x + (size_t)sb * SB;
  for (int i = tid; i < a.m * (SB / 8); i += THREADS) {
    const int r = i >> 5, c = (i & 31) << 3;
    cp_piece<16>(st + (r * XSTR + c) * 2, xs + (size_t)r * a.k_pad + c, 16);
  }
  const int n0 = blockIdx.x * NB;
  const int valid = (a.n - n0) * 4;               // bytes left in a row
  for (int i = tid; i < 2 * a.nme * (NB / 4); i += THREADS) {
    const int tab = i / (a.nme * (NB / 4));      // 0 scale, 1 zero
    const int e = i % (a.nme * (NB / 4));
    const int mi = e / (NB / 4), bo = (e % (NB / 4)) * 16;
    const int grp = (sb * SB) / a.group_rows + mi;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        tab ? static_cast<const void*>(a.zero)
            : static_cast<const void*>(a.scale)) + ((size_t)grp * a.n + n0) * 4;
    const int ok = min(16, max(0, valid - bo));
    cp_piece<16>(st + a.off_meta + (tab * a.nme + mi) * NB * 4 + bo,
                 src + (ok ? bo : 0), ok);
  }
}

// The B register of two rows of one column: the exact integers q as bf16
template <int BP0, int BP1, int S>
__device__ __forceinline__ uint32_t deq_q(uint32_t wa, uint32_t wb,
                                          uint32_t w1a, uint32_t w1b,
                                          uint32_t sel1, int rot1) {
  if constexpr (BP0 + BP1 <= 7) {
    const uint32_t q = pair_bits<BP0, BP1, S>(wa, wb, w1a, w1b, sel1, rot1,
                                              0x43004300u);
    return bf2_bits(__hsub2(bits_bf2(q), bits_bf2(0x43004300u)));
  } else {
    const uint32_t q = pair_bits<BP0, BP1, S>(wa, wb, w1a, w1b, sel1, rot1,
                                              0u);
    const uint32_t mg = 0x4b000000u;
    const float lo = __uint_as_float(__byte_perm(q, mg, 0x7610)) - 8388608.f;
    const float hi = __uint_as_float(__byte_perm(q, mg, 0x7632)) - 8388608.f;
    return bf2_bits(__floats2bfloat162_rn(lo, hi));
  }
}

template <int MT>
struct Tile {
  static constexpr int MTL = MT == 32 ? 2 : 1;
  float pg[MTL][4][4];      // group partials of the lane's accumulators
  float xs[MTL][4];         // activation sums (the ones tile)
  float acc[MTL][4][4];     // running sum of (pg - xs*z)*s
};

// (pg - xs*z)*s into acc for the group whose meta sits at index mi of the
// stage at `meta` (the lane's columns 8t .. 8t + 7 of its warp); clears pg
// and xs
template <int MT>
__device__ __forceinline__ void epilogue(const Args& a,
                                         const unsigned char* meta, int mi,
                                         Tile<MT>& tl) {
  const float4 s0 = *reinterpret_cast<const float4*>(meta + mi * NB * 4);
  const float4 s1 = *reinterpret_cast<const float4*>(meta + mi * NB * 4 + 16);
  const unsigned char* zp = meta + (a.nme + mi) * NB * 4;
  const int4 z0 = *reinterpret_cast<const int4*>(zp);
  const int4 z1 = *reinterpret_cast<const int4*>(zp + 16);
  const float s[2][4] = {{s0.x, s0.y, s0.z, s0.w}, {s1.x, s1.y, s1.z, s1.w}};
  const float z[2][4] = {{(float)z0.x, (float)z0.y, (float)z0.z, (float)z0.w},
                         {(float)z1.x, (float)z1.y, (float)z1.z,
                          (float)z1.w}};
#pragma unroll
  for (int mt = 0; mt < Tile<MT>::MTL; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // register r: token row g + 8(r >> 1), column 8t + 4(r & 1) + j
        const float xv = tl.xs[mt][r & 2];
        const float sv = s[r & 1][j], zv = z[r & 1][j];
        const float term =
            __fmul_rn(__fsub_rn(tl.pg[mt][j][r], __fmul_rn(xv, zv)), sv);
        tl.acc[mt][j][r] = __fadd_rn(tl.acc[mt][j][r], term);
        tl.pg[mt][j][r] = 0.f;
      }
#pragma unroll
    for (int r = 0; r < 4; ++r) tl.xs[mt][r] = 0.f;
  }
}

// slots S .. of one sub-block: xp the lane's activations in the stage (row
// g at column R*t), meta the lane's scale rows; is128: groups of 128 rows,
// sb_end: (else) a group ends with this sub-block
template <int BP0, int BP1, int MT, int S>
__device__ __forceinline__ void run_slots(
    const Args& a, const unsigned char* xp, const unsigned char* meta,
    const bool (&xok)[MT == 8 ? 1 : MT / 8], int t, bool is128, bool sb_end,
    const Words<BP0, BP1>& w, Tile<MT>& tl) {
  constexpr int R = 2 * BP0, Q0 = 8 * BP0;
  constexpr int XR = MT == 8 ? 1 : MT / 8;
  constexpr int MTL = Tile<MT>::MTL;
  if constexpr (S < 32 / BP0) {
    // the lane's R activations of rows g + 8u in the slot
    uint32_t x[XR][R / 2];
#pragma unroll
    for (int u = 0; u < XR; ++u) {
      const unsigned char* p = xp + (8 * u * XSTR + Q0 * S) * 2;
      if constexpr (R == 4) {
        const uint2 v = xok[u] ? *reinterpret_cast<const uint2*>(p)
                               : make_uint2(0, 0);
        x[u][0] = v.x;
        x[u][1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < R / 8; ++q) {
          const uint4 v = xok[u] ? reinterpret_cast<const uint4*>(p)[q]
                                 : make_uint4(0, 0, 0, 0);
          x[u][4 * q + 0] = v.x;
          x[u][4 * q + 1] = v.y;
          x[u][4 * q + 2] = v.z;
          x[u][4 * q + 3] = v.w;
        }
      }
    }
    uint32_t sel1;
    int rot1;
    plane1_shift<BP0, BP1, S>(t, sel1, rot1);
#pragma unroll
    for (int h = 0; h < BP0 / 2; ++h) {
      uint32_t af[MTL][4];
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) {
        af[mt][0] = x[2 * mt][2 * h];
        af[mt][2] = x[2 * mt][2 * h + 1];
        if constexpr (MT == 8) {
          af[mt][1] = 0u;
          af[mt][3] = 0u;
        } else {
          af[mt][1] = x[2 * mt + 1][2 * h];
          af[mt][3] = x[2 * mt + 1][2 * h + 1];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * h;
        const uint32_t b0 = deq_q<BP0, BP1, S>(
            comp(w.w0[i], j), comp(w.w0[i + 1], j),
            BP1 ? comp(w.w1[BP1 ? i : 0], j) : 0u,
            BP1 ? comp(w.w1[BP1 ? i + 1 : 0], j) : 0u, sel1, rot1);
        const uint32_t b1 = deq_q<BP0, BP1, S>(
            comp(w.w0[i + 2], j), comp(w.w0[i + 3], j),
            BP1 ? comp(w.w1[BP1 ? i + 2 : 0], j) : 0u,
            BP1 ? comp(w.w1[BP1 ? i + 3 : 0], j) : 0u, sel1, rot1);
#pragma unroll
        for (int mt = 0; mt < MTL; ++mt) mma_bf16(tl.pg[mt][j], af[mt], b0, b1);
      }
#pragma unroll
      for (int mt = 0; mt < MTL; ++mt) mma_bf16(tl.xs[mt], af[mt], ONES, ONES);
    }
    // does a group end with this slot? groups of 128 rows end at slot rows
    // 128 and 256 of the sub-block, larger ones with a sub-block
    constexpr bool END128 = (Q0 * (S + 1)) % 128 == 0;
    constexpr bool LAST = S + 1 == 32 / BP0;
    if (is128) {
      if constexpr (END128) epilogue<MT>(a, meta, (Q0 * (S + 1) - 1) / 128, tl);
    } else if constexpr (LAST) {
      if (sb_end) epilogue<MT>(a, meta, 0, tl);
    }
    run_slots<BP0, BP1, MT, S + 1>(a, xp, meta, xok, t, is128, sb_end, w, tl);
  }
}

// blocks per SM the register budget is cut for
__host__ __device__ constexpr int min_blocks(int mt) {
  return mt == 32 ? 2 : mt == 16 ? 3 : 4;
}

template <int BP0, int BP1, int MT>
__global__ void __launch_bounds__(THREADS, min_blocks(MT))
    partials_kernel(const Args a) {
  constexpr int R = 2 * BP0;
  constexpr int MTL = Tile<MT>::MTL;
  constexpr int XR = MT == 8 ? 1 : MT / 8;
  // the next sub-block's words are loaded ahead where registers allow
  constexpr bool AHEAD = BP1 == 0 && BP0 <= 4 && MT <= 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * NB;
  const int cw4 = warp * 32 + 4 * g;               // the lane's B columns
  const int c4 = n0 + cw4;
  const bool live = c4 < a.n;
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);
  const bool is128 = a.group_rows == 128;
  const int cw = warp * 32 + 8 * t;                // the lane's out columns
  const unsigned char* xp0 = smem + (g * XSTR + R * t) * 2;
  const unsigned char* mp0 = smem + a.off_meta + cw * 4;
  bool xok[XR];
#pragma unroll
  for (int u = 0; u < XR; ++u) xok[u] = g + 8 * u < a.m;

  Tile<MT> tl;
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tl.pg[mt][j][r] = 0.f;
        tl.acc[mt][j][r] = 0.f;
        tl.xs[mt][r] = 0.f;
      }

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
    const bool sb_end = ((sb + 1) * SB) % a.group_rows == 0;
    run_slots<BP0, BP1, MT, 0>(a, xp0 + off, mp0 + off, xok, t, is128,
                               sb_end, w, tl);
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
                make_float4(tl.acc[mt][0][r], tl.acc[mt][1][r],
                            tl.acc[mt][2][r], tl.acc[mt][3][r]);
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
              make_float4(tl.acc[mt][0][r], tl.acc[mt][1][r],
                          tl.acc[mt][2][r], tl.acc[mt][3][r]);
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

// the largest two-stage ring of an m-tile: the activation rows, then two
// meta rows each of scale and zero
constexpr int max_ring(int mt) {
  return 2 * (mt * XSTR * 2 + 2 * 2 * NB * 4);
}

template <int BP0, int BP1, int MT>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  const int bytes = 2 * a.stage_bytes;
  static bool opted_in = false;          // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        partials_kernel<BP0, BP1, MT>,
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
  return cudaLaunchKernelEx(&cfg, partials_kernel<BP0, BP1, MT>, a);
}

template <int BP0, int BP1>
cudaError_t launch_mt(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.m < 8) return launch<BP0, BP1, 8>(a, grid, st);
  if (a.m <= 16) return launch<BP0, BP1, 16>(a, grid, st);
  return launch<BP0, BP1, 32>(a, grid, st);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [m, k_pad] bf16; planes int32/uint32 [k_pad*bp/32, n]; scale f32 and
// zero int32 [k_pad / group_rows, n]; out [m, n] f32. Groups of 128 rows or
// a multiple of 256; splits <= 8 blocks of one cluster share a column block,
// each sb_per_split sub-blocks of K, a whole number of groups. n % 4 == 0,
// buffers 16-byte aligned. Returns the cudaError_t of the launch.
int qmm_partials_segment(const void* x, int m, int k_pad,
                         const void* plane0, const void* plane1, int bp0,
                         int bp1, int n, int group_rows, const void* scale,
                         const void* zero, void* out, int splits,
                         int sb_per_split, void* stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int unit = group_rows > SB ? group_rows / SB : 1;
  if (m < 1 || m > 32 || k_pad % SB || n % 4 || k_pad % group_rows ||
      (group_rows != 128 && group_rows % SB) || splits < 1 ||
      splits > MAX_SPLITS || sb_per_split < 1 || sb_per_split % unit ||
      (k_pad / SB + sb_per_split - 1) / sb_per_split != splits)
    return (int)cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(plane0) || (bp1 && !aligned(plane1)) ||
      !aligned(scale) || !aligned(zero) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.m = m;
  a.k_pad = k_pad;
  a.p0 = (const uint32_t*)plane0;
  a.p1 = (const uint32_t*)plane1;
  a.n = n;
  a.group_rows = group_rows;
  a.scale = (const float*)scale;
  a.zero = (const int*)zero;
  a.out = (float*)out;
  a.sb_per_split = sb_per_split;
  a.nsb = k_pad / SB;
  const int mt = m < 8 ? 8 : m <= 16 ? 16 : 32;
  a.nme = group_rows == 128 ? 2 : 1;
  a.off_meta = mt * XSTR * 2;
  a.stage_bytes = a.off_meta + 2 * a.nme * NB * 4;
  const dim3 grid((n + NB - 1) / NB, splits);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (bp0 * 10 + bp1) {
    case 20: e = launch_mt<2, 0>(a, grid, st); break;
    case 21: e = launch_mt<2, 1>(a, grid, st); break;
    case 40: e = launch_mt<4, 0>(a, grid, st); break;
    case 80: e = launch_mt<8, 0>(a, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
