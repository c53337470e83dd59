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
//   weight w  = bf16((q - z) * s), with
//               EXL2 prescaled:  s = scale_f[g, n] (bf16),      z = 2^(bits-1)
//               EXL2 encoded:    s = fp16(qs[g, n]^2 * smax[g]), z = 2^(bits-1)
//               GPTQ:            s = scale[g, n] (f32),          z = zero[g, n]
//   out[i, n] = sum_k f32(x[i, k]) * f32(w[k, n]), accumulated in f32.
// bf16 x bf16 products are exact in f32, so only the order of the sums can
// differ from the plain version (ops/qmm.py:qmm_plain).
//
// Bound on the H100: memory. At m <= 32 the kernel does 2*m flops for every
// 0.5-1 byte of weight it reads (bits/8 plus the group meta), far below the
// card's ~295 flop/byte ridge, so the least time is the weight bytes over
// 3.35 TB/s (4096x4096 at 4 bits, prescaled gs32: 9.4 MB -> 2.8 us).
//
// Design:
//   * one thread per output column, 128 columns per block: the words of a
//     plane row are [K*bp/32, N] row-major, so a warp reads 128 contiguous
//     bytes per plane row -- fully coalesced, no repack of the reference
//     layout;
//   * the activation rows of one 256-row sub-block are staged in shared
//     memory as f32 (<= 32 KB) and read as 16-byte broadcasts;
//   * each thread keeps its m accumulators in registers (template MT >= m);
//   * rows are visited in 16-row chunks: every real group size is a multiple
//     of 16, so a chunk has one scale; the 16 chunk scales of a sub-block
//     are loaded (and, for qscale/smax, decoded) together at its start;
//   * only the 16 values of a chunk are unrolled (the slot loop is not),
//     which keeps the 30 instantiations (5 row tiles x 6 plane pairs)
//     quick to compile;
//   * N = 4096 gives only 32 column blocks for 132 SMs, so K is split across
//     blockIdx.y; each split writes its own partial [split, m, N] and a
//     second kernel sums the splits in a fixed order (deterministic, no
//     float atomics).
// Later work: wgmma on dequantized tiles, cp.async/TMA pipelining, a
// Hopper-native repack of the planes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;
constexpr int SB = 256;

enum { META_SCALE_F = 0, META_QSCALE = 1, META_GPTQ = 2 };

struct Args {
  const __nv_bfloat16* x;
  int m, k_pad;
  const uint32_t* p0;
  const uint32_t* p1;
  int n, bits, group_rows, meta;
  const void* meta0;
  const void* meta1;
  float* dst;             // [splits, m, n] partials, or out when splits == 1
  int sb_per_split, nsb;
};

__device__ __forceinline__ void load_meta(const Args& a, int g, int col,
                                          float& s, float& z) {
  const size_t i = (size_t)g * a.n + col;
  if (a.meta == META_GPTQ) {
    s = static_cast<const float*>(a.meta0)[i];
    z = (float)static_cast<const int*>(a.meta1)[i];
  } else {
    z = (float)(1 << (a.bits - 1));
    if (a.meta == META_SCALE_F) {
      s = __bfloat162float(static_cast<const __nv_bfloat16*>(a.meta0)[i]);
    } else {
      const int qs = static_cast<const uint8_t*>(a.meta0)[i];
      const float smax = static_cast<const float*>(a.meta1)[g];
      s = __half2float(__float2half_rn((float)(qs * qs) * smax));
    }
  }
}

template <int BP0, int BP1, int MT>
__global__ void __launch_bounds__(COLS) qmm_kernel(const Args a) {
  constexpr int QSB0 = SB * BP0 / 32;       // plane-0 words per sub-block
  constexpr int PER0 = 32 / BP0;            // values per plane-0 word
  constexpr int QSB1 = BP1 ? SB * BP1 / 32 : 1;
  constexpr uint32_t MASK0 = (1u << BP0) - 1u;
  constexpr uint32_t MASK1 = BP1 ? (1u << BP1) - 1u : 0u;
  static_assert(QSB0 % 16 == 0, "plane 0 needs >= 16 words per sub-block");
  static_assert(BP1 == 0 || QSB1 == 8 || QSB1 == 16, "plane 1 is 1 or 2 bits");

  __shared__ __align__(16) float xs[MT][SB];
  // per-thread scale / zero of each 16-row chunk of the current sub-block
  // (only the owning thread reads its column); zeros are integers <= 256
  __shared__ float cs[SB / 16][COLS];
  __shared__ uint16_t cz[SB / 16][COLS];

  const int col = blockIdx.x * COLS + threadIdx.x;
  const bool live = col < a.n;
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  for (int sb = sb0; sb < sb1; ++sb) {
    __syncthreads();                        // previous sub-block's reads done
    for (int i = threadIdx.x; i < MT * SB; i += COLS) {
      const int r = i / SB, c = i % SB;
      xs[r][c] = r < a.m
          ? __bfloat162float(a.x[(size_t)r * a.k_pad + (size_t)sb * SB + c])
          : 0.f;
    }
    if (live) {
      // every real group size is a multiple of 16: one scale per chunk,
      // all 16 loaded at once
#pragma unroll
      for (int c = 0; c < SB / 16; ++c) {
        float s, z;
        load_meta(a, (sb * SB + c * 16) / a.group_rows, col, s, z);
        cs[c][threadIdx.x] = s;
        cz[c][threadIdx.x] = (uint16_t)z;
      }
    }
    __syncthreads();
    if (!live) continue;

    uint32_t w1[QSB1];
    if (BP1) {
#pragma unroll
      for (int j = 0; j < QSB1; ++j)
        w1[j] = a.p1[((size_t)sb * QSB1 + j) * a.n + col];
    }

#pragma unroll 1
    for (int wc = 0; wc < QSB0 / 16; ++wc) {
      uint32_t w0[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w0[i] = a.p0[((size_t)sb * QSB0 + wc * 16 + i) * a.n + col];

#pragma unroll 1
      for (int j = 0; j < PER0; ++j) {
        // rows j*QSB0 + wc*16 + i (i < 16) of the sub-block: one 16-row chunk
        const int c = j * (QSB0 / 16) + wc;
        const float s = cs[c][threadIdx.x], z = (float)cz[c][threadIdx.x];
        float wv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          uint32_t v = (w0[i] >> (j * BP0)) & MASK0;
          if (BP1) {
            // plane 1: row r = c*16 + i lives in word r % QSB1 (== i % QSB1
            // since 16 % QSB1 == 0) at slot r / QSB1
            const int r = c * 16 + i;
            v |= ((w1[i % QSB1] >> ((r / QSB1) * BP1)) & MASK1) << BP0;
          }
          wv[i] = __bfloat162float(__float2bfloat16_rn(((float)v - z) * s));
        }
        // 16-byte shared loads: four activation values per instruction
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float4* xr = reinterpret_cast<const float4*>(&xs[mi][c * 16]);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = xr[q];
            acc[mi] = fmaf(xv.x, wv[4 * q + 0], acc[mi]);
            acc[mi] = fmaf(xv.y, wv[4 * q + 1], acc[mi]);
            acc[mi] = fmaf(xv.z, wv[4 * q + 2], acc[mi]);
            acc[mi] = fmaf(xv.w, wv[4 * q + 3], acc[mi]);
          }
        }
      }
    }
  }

  if (live) {
    float* dst = a.dst + (size_t)blockIdx.y * a.m * a.n;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      if (mi < a.m) dst[(size_t)mi * a.n + col] = acc[mi];
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
  if (a.m <= 1)       qmm_kernel<BP0, BP1, 1><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 4)  qmm_kernel<BP0, BP1, 4><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 8)  qmm_kernel<BP0, BP1, 8><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 16) qmm_kernel<BP0, BP1, 16><<<grid, COLS, 0, st>>>(a);
  else                qmm_kernel<BP0, BP1, 32><<<grid, COLS, 0, st>>>(a);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [m, k_pad] bf16; planes int32/uint32 [k_pad*bp/32, n]; meta as in
// load_meta; part [splits, m, n] f32 (ignored when splits == 1); out [m, n].
// Returns the cudaError_t of the launches (0 on success).
int qmm_segment(const void* x, int m, int k_pad,
                const void* plane0, const void* plane1, int bp0, int bp1,
                int n, int bits, int group_rows, int meta,
                const void* meta0, const void* meta1,
                void* part, void* out, int splits, int sb_per_split,
                void* stream) {
  if (m < 1 || m > 32 || k_pad % SB || group_rows % 16 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
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
  a.dst = (float*)(splits == 1 ? out : part);
  a.sb_per_split = sb_per_split;
  a.nsb = k_pad / SB;
  dim3 grid((n + COLS - 1) / COLS, splits);
  const int key = bp0 * 10 + bp1;
  switch (key) {
    case 20: launch_mt<2, 0>(a, grid, st); break;
    case 40: launch_mt<4, 0>(a, grid, st); break;
    case 80: launch_mt<8, 0>(a, grid, st); break;
    case 21: launch_mt<2, 1>(a, grid, st); break;
    case 41: launch_mt<4, 1>(a, grid, st); break;
    case 42: launch_mt<4, 2>(a, grid, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t count = (size_t)m * n;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
