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
// card, so the least time is the weight and meta bytes over 3.35 TB/s.
//
// Design:
//   * one thread per output column, 128 columns per block, K split across
//     blockIdx.y with a fixed-order second pass, as in qmm.cu;
//   * the plane layout puts natural row r of a 256-row sub-block in word
//     (r mod Qsb) at slot (r div Qsb): one slot of all Qsb words is a run of
//     Qsb consecutive rows. A thread loads the Qsb words of its column for
//     the whole sub-block into registers (16, 32 or 64 of them) and walks
//     the slots in order, so rows arrive in natural order and one set of m
//     int32 accumulators serves one group at a time, whatever gr is. The
//     cheap nibble split (word & 0x0F0F0F0F) would instead pair rows 64
//     apart, which cross a group boundary at gr <= 64;
//   * the 16 values of a chunk are extracted as in qmm.cu (both planes of a
//     3/5/6-bit value), packed four to a register in row order, and meet
//     the int8 activations with dp4a; the activations of a sub-block sit in
//     shared memory in natural order, read as 16-byte broadcasts;
//   * the group's scale, zero, a and x1a are staged in shared memory per
//     16-row chunk at the start of a sub-block, and the fix-up runs where a
//     chunk ends a group.
// Later work: mma.sync / wgmma int8 tiles, cp.async / TMA pipelining, a
// Hopper-native repack of the planes.

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
// f32 (ignored when splits == 1); out [m, n].
// A split holds whole groups. Returns the cudaError_t of the launches.
int qmm_w4a8_segment(const void* x, int m, int k_pad, void* xq, void* a_out,
                     void* x1a_out, const void* plane0, const void* plane1,
                     int bp0, int bp1, int n, int bits, int group_rows,
                     int meta, const void* meta0, const void* meta1,
                     void* part, void* out, int splits, int sb_per_split,
                     void* stream) {
  if (m < 1 || m > 32 || k_pad % SB || group_rows % 16 || splits < 1 ||
      k_pad % group_rows || (SB % group_rows && group_rows % SB) ||
      (group_rows > SB && splits > 1 && sb_per_split % (group_rows / SB)))
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
