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
//    k, little-endian -- what a register holds on this card and what dp4a
//    consumes. Per group of gr rows, word rows g*gr/8 .. (g+1)*gr/8: the
//    first gr/2 activations meet the lo bytes, the second gr/2 the hi
//    bytes, in int32; y = sum_g s_g * f32(p_g) - 8 * (x1 @ s), x1 [8, K/gr]
//    the per-group sums of xq.
//    Bound: memory, as for gp (x1 read too).
//    Design: one thread per column, two ALU operations per word to extract
//    eight values, two dp4a per word and row. A block takes nt columns and
//    kt rows of K (the caller's tile hints); x is staged 256 rows at a time.
//
// Later work for all three: cp.async / TMA pipelining, mma.sync tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

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

// fp16(qs^2 * smax) as f32: the EXL2 group scale
__device__ __forceinline__ float group_scale(const uint8_t* qs,
                                             const float* smax, int g, int n,
                                             int col) {
  const int q = qs[(size_t)g * n + col];
  return __half2float(__float2half_rn(__fmul_rn((float)(q * q), smax[g])));
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

struct NibArgs {
  const int8_t* xq;         // [8, k]
  const float* x1;          // [8, k / gr]
  const uint32_t* plane;    // [k / 8, n]
  const uint8_t* qs;        // [k / gr, n]
  const float* smax;        // [k / gr]
  int k, n, gr, kt;
  float* dst;               // [splits, 8, n] partials, or out when one split
};

__global__ void __launch_bounds__(256) nibble_kernel(const NibArgs a) {
  __shared__ __align__(16) int xs[MROWS][SB / 4];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = col < a.n;
  const int gr = a.gr;
  const int groups = a.k / gr;
  const int k0 = blockIdx.y * a.kt;
  const int k1 = min(k0 + a.kt, a.k);

  float facc[MROWS], corr[MROWS];
#pragma unroll
  for (int m = 0; m < MROWS; ++m) {
    facc[m] = 0.f;
    corr[m] = 0.f;
  }

  for (int kb = k0; kb < k1; kb += SB) {
    __syncthreads();
    for (int i = threadIdx.x; i < MROWS * (SB / 4); i += blockDim.x) {
      const int m = i / (SB / 4), w = i % (SB / 4);
      xs[m][w] =
          reinterpret_cast<const int*>(a.xq + (size_t)m * a.k + kb)[w];
    }
    __syncthreads();
    if (!live) continue;
    for (int r0 = 0; r0 < SB; r0 += gr) {   // one group of the sub-block
      const int g = (kb + r0) / gr;
      const size_t wbase = (size_t)(kb + r0) / 8;
      int iacc[MROWS];
#pragma unroll
      for (int m = 0; m < MROWS; ++m) iacc[m] = 0;
      for (int q = 0; q < gr / 8; ++q) {
        const uint32_t w = a.plane[(wbase + q) * a.n + col];
        // mapping A: byte j of lo (hi) is row 4q + j of the group's first
        // (second) half
        const int lo = (int)(w & 0x0F0F0F0Fu);
        const int hi = (int)((w >> 4) & 0x0F0F0F0Fu);
#pragma unroll
        for (int m = 0; m < MROWS; ++m) {
          int acc = iacc[m];
          acc = __dp4a(xs[m][r0 / 4 + q], lo, acc);
          acc = __dp4a(xs[m][(r0 + gr / 2) / 4 + q], hi, acc);
          iacc[m] = acc;
        }
      }
      const float s = group_scale(a.qs, a.smax, g, a.n, col);
#pragma unroll
      for (int m = 0; m < MROWS; ++m) {
        facc[m] = __fadd_rn(facc[m], __fmul_rn((float)iacc[m], s));
        corr[m] = __fadd_rn(corr[m],
                            __fmul_rn(a.x1[(size_t)m * groups + g], s));
      }
    }
  }

  if (live) {
    float* dst = a.dst + (size_t)blockIdx.y * MROWS * a.n;
#pragma unroll
    for (int m = 0; m < MROWS; ++m)
      dst[(size_t)m * a.n + col] =
          __fsub_rn(facc[m], __fmul_rn(8.f, corr[m]));
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
// above; a block takes kt rows of K (a multiple of 256) and nt columns (a
// multiple of 32, at most 256); part f32 [ceil(k/kt), 8, n]; out f32 [8, n].
int perf_nibble(const void* xq, const void* x1, const void* plane,
                const void* qs, const void* smax, int k, int n, int gr,
                int kt, int nt, void* part, void* out, void* stream) {
  if (k < SB || k % SB || !group_ok(gr) || kt < SB || kt % SB || nt < 32 ||
      nt > 256 || nt % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int splits = (k + kt - 1) / kt;
  NibArgs a;
  a.xq = (const int8_t*)xq;
  a.x1 = (const float*)x1;
  a.plane = (const uint32_t*)plane;
  a.qs = (const uint8_t*)qs;
  a.smax = (const float*)smax;
  a.k = k;
  a.n = n;
  a.gr = gr;
  a.kt = kt;
  a.dst = (float*)(splits == 1 ? out : part);
  nibble_kernel<<<dim3((n + nt - 1) / nt, splits), nt, 0, st>>>(a);
  return (int)reduce(part, out, splits, n, st);
}

}  // extern "C"
