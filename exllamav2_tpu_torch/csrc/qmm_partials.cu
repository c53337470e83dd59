// GPTQ scales-on-partials matmul for few activation rows (exact):
//   out[m, N] = sum_g s_g * (x_g @ v_g - z_g * sum(x_g)),
// the dequant-matmul x @ ((v - z) * s) with scale and zero moved from every
// weight value to the per-group partial sums.
//
// Replaces: exllamav2_tpu/ops/qmm.py:_partials_gptq_matmul (the Pallas
// kernel at qmm.py:225). Serves GPTQ segments with groups of >= 128 rows
// when QMM_PARTIALS=1 (ops/qmm.py:_use_partials).
//
// Function (groups of gr rows, G = K / gr):
//   pass 1 (group_sum_kernel): xs[i, g] = sum of the bf16 activations of
//     token i over group g, in f32;
//   pass 2 (partials_kernel), per group: pg = sum_r f32(x[i, r]) * v[r, n]
//     (a bf16 times an integer <= 255 is exact in f32, the sum is f32);
//     term = (pg - xs * z) * s with f32 s and integer z;
//     out[i, n] = sum_g term.
// Kernel and plain version (ops/qmm.py:qmm_partials_plain) differ in the
// order of the f32 sums only. Against the fused dequant-matmul (qmm.cu) the
// result differs by that kernel's bf16 rounding of each weight.
//
// Bound on the H100: memory, as for qmm.cu: the weight and meta bytes over
// 3.35 TB/s.
//
// Design: as qmm_w4a8.cu. One thread per output column, 128 columns per
// block, K split across blockIdx.y with a fixed-order second pass; a thread
// holds the plane words of its column for a whole 256-row sub-block in
// registers and walks the slots in order, so rows arrive in natural order
// and one set of m f32 group accumulators serves one group at a time; the
// per-value work is one integer-to-float conversion and m fused
// multiply-adds; scale, zero and xs are staged in shared memory per 16-row
// chunk and applied where a chunk ends a group.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 128;
constexpr int SB = 256;
constexpr int NCHUNK = SB / 16;

struct Args {
  const __nv_bfloat16* x;   // [m, k_pad]
  const float* xsum;        // [m, groups]
  int m, k_pad, groups;
  const uint32_t* p0;
  const uint32_t* p1;
  int n, group_rows;
  const float* scale;       // [groups, n]
  const int* zero;          // [groups, n]
  float* dst;               // [splits, m, n] partials, or out
  int sb_per_split, nsb;
};

// one warp per (token, group)
__global__ void group_sum_kernel(const __nv_bfloat16* __restrict__ x,
                                 int k_pad, int gr, int groups,
                                 float* __restrict__ xsum) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r = blockIdx.y;
  if (g >= groups) return;
  const size_t base = (size_t)r * k_pad + (size_t)g * gr;
  float s = 0.f;
  for (int i = lane; i < gr; i += 32) s += __bfloat162float(x[base + i]);
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) xsum[(size_t)r * groups + g] = s;
}

template <int BP0, int BP1, int MT>
__global__ void __launch_bounds__(COLS) partials_kernel(const Args a) {
  constexpr int QSB0 = SB * BP0 / 32;       // plane-0 words per sub-block
  constexpr int PER0 = 32 / BP0;            // slots per plane-0 word
  constexpr int NCH = QSB0 / 16;            // 16-row chunks per slot
  constexpr int QSB1 = BP1 ? SB * BP1 / 32 : 1;
  constexpr uint32_t MASK0 = (1u << BP0) - 1u;
  constexpr uint32_t MASK1 = BP1 ? (1u << BP1) - 1u : 0u;
  static_assert(QSB0 % 16 == 0, "plane 0 needs >= 16 words per sub-block");
  static_assert(BP1 == 0 || QSB1 == 8 || QSB1 == 16, "plane 1 is 1 or 2 bits");

  __shared__ __align__(16) float xs[MT][SB];
  // per 16-row chunk of the sub-block: its group's scale and zero for the
  // thread's column, and its group's activation sum for each token
  // (zeros are integers <= 256; 16 bits keep the block under 48 KB)
  __shared__ float cs[NCHUNK][COLS];
  __shared__ uint16_t cz[NCHUNK][COLS];
  __shared__ float sx[NCHUNK][MT];

  const int col = blockIdx.x * COLS + threadIdx.x;
  const bool live = col < a.n;
  const int gr = a.group_rows;
  const int sb0 = blockIdx.y * a.sb_per_split;
  const int sb1 = min(sb0 + a.sb_per_split, a.nsb);

  float gacc[MT], facc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    gacc[i] = 0.f;
    facc[i] = 0.f;
  }

  for (int sb = sb0; sb < sb1; ++sb) {
    __syncthreads();                        // previous sub-block's reads done
    for (int i = threadIdx.x; i < MT * SB; i += COLS) {
      const int r = i / SB, c = i % SB;
      xs[r][c] = r < a.m
          ? __bfloat162float(a.x[(size_t)r * a.k_pad + (size_t)sb * SB + c])
          : 0.f;
    }
    for (int i = threadIdx.x; i < NCHUNK * MT; i += COLS) {
      const int c = i / MT, r = i % MT;
      sx[c][r] = r < a.m
          ? a.xsum[(size_t)r * a.groups + (sb * SB + c * 16) / gr] : 0.f;
    }
    if (live) {
      float s = 0.f;
      uint16_t z = 0;
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) {
        const int row = sb * SB + c * 16;
        if (c == 0 || row % gr == 0) {
          const size_t i = (size_t)(row / gr) * a.n + col;
          s = a.scale[i];
          z = (uint16_t)a.zero[i];
        }
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
        float wv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          uint32_t v = (w0[wc * 16 + i] >> (j * BP0)) & MASK0;
          if (BP1) {
            // plane 1: row r lives in word r % QSB1 (== i % QSB1 since
            // 16 % QSB1 == 0) at slot r / QSB1
            const int r = c * 16 + i;
            v |= ((w1[i % QSB1] >> ((r / QSB1) * BP1)) & MASK1) << BP0;
          }
          wv[i] = (float)v;
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float4* xr = reinterpret_cast<const float4*>(&xs[mi][c * 16]);
          float acc = gacc[mi];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = xr[q];
            acc = fmaf(xv.x, wv[4 * q + 0], acc);
            acc = fmaf(xv.y, wv[4 * q + 1], acc);
            acc = fmaf(xv.z, wv[4 * q + 2], acc);
            acc = fmaf(xv.w, wv[4 * q + 3], acc);
          }
          gacc[mi] = acc;
        }
        if ((sb * SB + (c + 1) * 16) % gr == 0) {
          // the chunk ends its group: scale and zero on the partial
          const float s = cs[c][threadIdx.x];
          const float z = (float)cz[c][threadIdx.x];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const float t = __fmul_rn(
                __fsub_rn(gacc[mi], __fmul_rn(sx[c][mi], z)), s);
            facc[mi] = __fadd_rn(facc[mi], t);
            gacc[mi] = 0.f;
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
  if (a.m <= 1)       partials_kernel<BP0, BP1, 1><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 4)  partials_kernel<BP0, BP1, 4><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 8)  partials_kernel<BP0, BP1, 8><<<grid, COLS, 0, st>>>(a);
  else if (a.m <= 16) partials_kernel<BP0, BP1, 16><<<grid, COLS, 0, st>>>(a);
  else                partials_kernel<BP0, BP1, 32><<<grid, COLS, 0, st>>>(a);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [m, k_pad] bf16; scratch xsum [m, k_pad / group_rows] f32; planes
// int32/uint32 [k_pad*bp/32, n]; scale f32 and zero int32 [groups, n];
// part [splits, m, n] f32 (ignored when splits == 1); out [m, n]. A split
// holds whole groups. Returns the cudaError_t of the launches.
int qmm_partials_segment(const void* x, int m, int k_pad, void* xsum,
                         const void* plane0, const void* plane1, int bp0,
                         int bp1, int n, int group_rows, const void* scale,
                         const void* zero, void* part, void* out, int splits,
                         int sb_per_split, void* stream) {
  if (m < 1 || m > 32 || k_pad % SB || group_rows % 16 || splits < 1 ||
      k_pad % group_rows || (SB % group_rows && group_rows % SB) ||
      (group_rows > SB && splits > 1 && sb_per_split % (group_rows / SB)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = k_pad / group_rows;
  group_sum_kernel<<<dim3((groups + 3) / 4, m), 128, 0, st>>>(
      (const __nv_bfloat16*)x, k_pad, group_rows, groups, (float*)xsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.x = (const __nv_bfloat16*)x;
  a.xsum = (const float*)xsum;
  a.m = m;
  a.k_pad = k_pad;
  a.groups = groups;
  a.p0 = (const uint32_t*)plane0;
  a.p1 = (const uint32_t*)plane1;
  a.n = n;
  a.group_rows = group_rows;
  a.scale = (const float*)scale;
  a.zero = (const int*)zero;
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
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t count = (size_t)m * n;
  reduce_splits<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)out, splits, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
