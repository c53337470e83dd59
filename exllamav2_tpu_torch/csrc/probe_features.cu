// Feature probes: ten small kernels, one per question about what the card's
// instructions do with low-precision data. Each computes the function of the
// probe of the same name in the JAX package's tools/probe_features.py, with
// the instruction a redesign of the quantized-matmul kernels would rely on.
//
// Replaces: tools/probe_features.py -- the Pallas kernels of int8_dot (:36),
// int8_dot_batched (:65), u32_to_int8_cast (:90), bitcast_u32_u16 (:117),
// u16_shift_and (:140), u8_shift_and (:164), int4_array (:187), int4_dot
// (:212), bf16_dot_bf16_acc_f32 (:237) and bitcast_u32_i8 (:263).
//
// Bound: every probe is at most [256, 256]; its bytes and operations are
// far below a microsecond of the card, so a launch is latency. What counts
// is that the instruction exists and gives the plain version's values.
//
// Design: a block of warps per output tile for the dots, K spread over its
// warps; one thread per 32-bit register for the rest.
//   * int8 dots: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on a
//     16-row, 32-column tile a block (one warp for each 64 rows of K, 1 to
//     8, k-steps round the warps, two a pass). Every load of a pass is
//     issued before its first mma, straight into the fragment registers,
//     the loads alone and predicated, the arithmetic on them after (4- or
//     2-byte loads: each byte is read by one lane). Staging A and B in
//     shared memory by cp.async first, as the bf16 dot does, measured
//     0.4-0.6 us slower a call (tools/int8_dot_sweep.py times both). A is
//     row-major [M, K]; B is row-major [K, N]: lane (g, t) loads one word
//     of columns 4g..4g+3 from each of its eight rows and a byte transpose
//     (prmt) of four rows gives four k-consecutive values of one column,
//     the B register of n-tile j for column 4g + j (the n-tiles' columns
//     interleaved, so no value is gathered twice). The warps' int32 tiles
//     are summed in shared memory in warp order, four columns a thread and
//     16 bytes a shared-memory access (a lane's four n-tiles of one
//     register are four consecutive columns): one launch. The batched probe
//     is the W4A8 kernel's group-of-32 partial: 8 activation rows padded to
//     the 16 of the tile (the upper A registers are zero), one warp a
//     block, which stores its registers.
//   * bf16 dot: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. A
//     block of 8 warps takes 16 columns; the K walk is spread over its warps
//     (a few k-steps each). Every load of the block is issued before the
//     first mma: A and B go to shared memory by 16-byte cp.async, and the
//     fragments come out with ldmatrix (.trans for the row-major B). The
//     warps' f32 partial tiles are summed in shared memory in warp order:
//     one launch, one memory round trip (K past 512 rows takes another
//     pass), no global scratch.
//   * int4: there is no 4-bit storage type here. The input is packed two
//     signed nibbles a byte, low nibble first (element 2c of a row is the low
//     nibble of byte c); the dot kernel places each nibble in the high half
//     of a byte (16 v, exact in int8) in the same pass as the transpose and
//     shifts the int32 sum back by 4: a shift pair that sign-extends.
//   * casts and shifts work on whole registers: four masked values packed
//     into one register with prmt (__byte_perm); (v >> 4) & 15 on two 16-bit
//     or four 8-bit sub-words with one shift and one mask.
//   * reinterpretations take the register apart through ushort2 / char4:
//     element j goes to row 2k + j (4k + j), so the host can tell which
//     byte the card calls element j (little-endian: mapping A).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int ID_WARPS = 8;                  // warps of a block, at most
constexpr int ID_NB = 32;                    // columns a block
constexpr int ID_STEPS = 2;                  // k-steps of 32 a warp, a pass
constexpr int ID_RSTR = ID_NB + 4;          // tile sum row stride (ints)

// byte b of each of four words, word i in byte i: a 4x4 byte transpose
// whose first two prmt serve two values of b
__device__ __forceinline__ uint32_t byte_of4(uint32_t m0, uint32_t m1,
                                             uint32_t m2, uint32_t m3,
                                             int b) {
  const uint32_t pair = b < 2 ? 0x5140u : 0x7362u;
  const uint32_t x01 = __byte_perm(m0, m1, pair);
  const uint32_t x23 = __byte_perm(m2, m3, pair);
  return __byte_perm(x01, x23, (b & 1) ? 0x7632u : 0x5410u);
}

// columns col .. col+3 of one row of B: a word of int8, or the 16 bits of
// two signed nibbles a byte
template <bool INT4>
__device__ __forceinline__ uint32_t b_load(const uint8_t* row, int col) {
  if constexpr (INT4)
    return *reinterpret_cast<const uint16_t*>(row + col / 2);
  else
    return *reinterpret_cast<const uint32_t*>(row + col);
}

// b_load's value as four bytes: int4 places each nibble in the high half of
// its byte (16 v, exact in int8; the product's sum is shifted back by 4 at
// the end, so the pair of shifts sign-extends)
template <bool INT4>
__device__ __forceinline__ uint32_t b_bytes(uint32_t v) {
  if constexpr (INT4) {
    const uint32_t x = __byte_perm(v, 0u, 0x1100u);   // b0 b0 b1 b1
    return (x & 0xF000F000u) | ((x << 4) & 0x00F000F0u);
  } else {
    return v;
  }
}

// c[g, :mrows, :] = a[g, :mrows, :] @ b[g] on int8 m16n8k32 tiles. A block of
// nw warps takes a 16-row, 32-column output tile; warp w takes k-steps w,
// w + nw, ... (ID_STEPS a pass, every load of a pass issued before its
// first mma, straight into the registers of the fragments). Lane (g, t)
// loads rows 4t..4t+3 and 16+4t..16+4t+3 of B at columns 4g..4g+3, one word
// a row, and transposes them by bytes: register j is column 4g + j, four
// k-consecutive values, the B of n-tile j, whose mma column g is output
// column 4g + j. The warps' int32 tiles are summed in shared memory in warp
// order, four columns a thread (rows padded by 4 ints, so the 16-byte
// stores of a quarter warp hit 32 banks); a block of one warp stores its
// registers. Rows past mrows are fed as zeros and not written.
template <bool INT4>
__global__ void __launch_bounds__(32 * ID_WARPS)
int8_dot_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int* __restrict__ c, int mrows, int kdim, int ncols) {
  __shared__ __align__(16) int red[ID_WARPS][16][ID_RSTR];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * ID_NB, m0 = blockIdx.y * 16, g = blockIdx.z;
  const size_t brow = INT4 ? ncols / 2 : ncols;      // bytes a row of B
  a += (size_t)g * mrows * kdim;
  b += (size_t)g * kdim * brow;
  const int col = n0 + 4 * gid;
  const int8_t* ar0 = a + (size_t)(m0 + gid) * kdim + 4 * tig;
  const int8_t* ar1 = ar0 + (size_t)8 * kdim;
  const bool live0 = m0 + gid < mrows, live1 = m0 + gid + 8 < mrows;
  int acc[4][4] = {};
  for (int k0 = warp * 32; k0 < kdim; k0 += nw * 32 * ID_STEPS) {
    // the loads alone first, predicated, then the arithmetic on them
    uint32_t ra[ID_STEPS][4], bw[ID_STEPS][8];
#pragma unroll
    for (int s = 0; s < ID_STEPS; ++s) {
      const int kk = k0 + s * nw * 32;
      const bool on = kk < kdim, bon = on && col < ncols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[s][2 * h] = on && live0 ? *reinterpret_cast<const uint32_t*>(
                                         ar0 + kk + 16 * h) : 0u;
        ra[s][2 * h + 1] = on && live1 ? *reinterpret_cast<const uint32_t*>(
                                             ar1 + kk + 16 * h) : 0u;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = kk + 16 * (i >> 2) + 4 * tig + (i & 3);
        bw[s][i] = bon ? b_load<INT4>(b + row * brow, col) : 0u;
      }
    }
#pragma unroll
    for (int s = 0; s < ID_STEPS; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t rb[2] = {
            byte_of4(b_bytes<INT4>(bw[s][0]), b_bytes<INT4>(bw[s][1]),
                     b_bytes<INT4>(bw[s][2]), b_bytes<INT4>(bw[s][3]), j),
            byte_of4(b_bytes<INT4>(bw[s][4]), b_bytes<INT4>(bw[s][5]),
                     b_bytes<INT4>(bw[s][6]), b_bytes<INT4>(bw[s][7]), j)};
        mma_s8(acc[j], ra[s], rb);
      }
  }
  // lane register r of n-tile j: row gid + 8 (r >> 1), mma column
  // 2 tig + (r & 1), output column 4 (2 tig + (r & 1)) + j
  c += (size_t)g * mrows * ncols;
  if (nw == 1) {                              // one warp: no sum to take
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + gid + 8 * (r >> 1);
        const int cc = n0 + 4 * (2 * tig + (r & 1)) + j;
        if (row < mrows && cc < ncols)
          c[(size_t)row * ncols + cc] = INT4 ? acc[j][r] >> 4 : acc[j][r];
      }
    return;
  }
  // the four n-tiles of one r are four consecutive columns: one 16-byte
  // store each; thread e then sums columns 4 (e % 8) .. +3 of row e / 8
  // over the warps in warp order
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<int4*>(
        &red[warp][gid + 8 * (r >> 1)][4 * (2 * tig + (r & 1))]) =
        make_int4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * ID_NB / 4; e += blockDim.x) {
    const int row = e >> 3, q = 4 * (e & 7);
    int4 s = *reinterpret_cast<const int4*>(&red[0][row][q]);
    for (int w = 1; w < nw; ++w) {
      const int4 v = *reinterpret_cast<const int4*>(&red[w][row][q]);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    if (m0 + row < mrows && n0 + q < ncols) {     // n % 8 == 0: all four
      int* o = c + (size_t)(m0 + row) * ncols + n0 + q;
      o[0] = INT4 ? s.x >> 4 : s.x;
      o[1] = INT4 ? s.y >> 4 : s.y;
      o[2] = INT4 ? s.z >> 4 : s.z;
      o[3] = INT4 ? s.w >> 4 : s.w;
    }
  }
}

constexpr int BF_WARPS = 8;
constexpr int BF_NB = 16;                    // columns a block
constexpr int BF_STEPS = 4;                  // k-steps of 16 a warp, a pass
constexpr int BF_CHUNK = BF_WARPS * BF_STEPS * 16;   // K rows a pass
constexpr int BF_ASTR = BF_CHUNK + 8;        // A row stride (bf16), padded

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p,
                                            bool trans) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// c [16, n] f32 = a [16, k] bf16 @ b [k, n] bf16: a block of 8 warps per 16
// columns, warp w takes k-steps 4w .. 4w+3 of each 512-row pass
__global__ void __launch_bounds__(32 * BF_WARPS)
bf16_dot_kernel(const __nv_bfloat16* __restrict__ a,
                const __nv_bfloat16* __restrict__ b, float* __restrict__ c,
                int kdim, int ncols) {
  __shared__ __align__(16) __nv_bfloat16 as[16][BF_ASTR];
  __shared__ __align__(16) __nv_bfloat16 bs[BF_CHUNK][BF_NB];
  __shared__ float red[BF_WARPS][16][BF_NB];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BF_NB;
  float acc[2][4] = {};
  for (int kc = 0; kc < kdim; kc += BF_CHUNK) {
    const int rows = min(BF_CHUNK, kdim - kc);
    if (kc) __syncthreads();                 // the last pass's reads done
    // A: 16 rows x `rows` columns, B: `rows` rows x 16 columns, 8 bf16 a
    // piece; B's columns past ncols read as zeros
    for (int i = threadIdx.x; i < 16 * (BF_CHUNK / 8); i += 32 * BF_WARPS) {
      const int r = i / (BF_CHUNK / 8), q = (i % (BF_CHUNK / 8)) * 8;
      if (q < rows)
        cp_async16(&as[r][q], a + (size_t)r * kdim + kc + q, 16);
    }
    for (int i = threadIdx.x; i < rows * 2; i += 32 * BF_WARPS) {
      const int r = i >> 1, q = (i & 1) * 8;
      const bool ok = n0 + q < ncols;
      cp_async16(&bs[r][q], ok ? b + (size_t)(kc + r) * ncols + n0 + q : b,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BF_STEPS; ++i) {
      const int kk = (warp * BF_STEPS + i) * 16;
      if (kk >= rows) break;
      // lane l addresses row l % 8 of matrix l / 8: A's (rows 0-7 | 8-15) x
      // (k 0-7 | 8-15) give a0-a3; B's (k 0-7 | 8-15) x (n 0-7 | 8-15),
      // transposed, give b0, b1 of the two n8 tiles
      const int mi = lane >> 3, ri = lane & 7;
      uint32_t ra[4], rb[4];
      ldmatrix_x4(ra, &as[ri + 8 * (mi & 1)][kk + 8 * (mi >> 1)], false);
      ldmatrix_x4(rb, &bs[kk + ri + 8 * (mi & 1)][8 * (mi >> 1)], true);
      const uint32_t tile0[2] = {rb[0], rb[1]}, tile1[2] = {rb[2], rb[3]};
      mma_bf16(acc[0], ra, tile0);
      mma_bf16(acc[1], ra, tile1);
    }
  }
  // lane register r of n-tile j: row gid + 8 (r >> 1), column 8j + 2 tig +
  // (r & 1)
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      red[warp][gid + 8 * (r >> 1)][8 * j + 2 * tig + (r & 1)] = acc[j][r];
  __syncthreads();
  const int row = threadIdx.x / BF_NB, col = threadIdx.x % BF_NB;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < BF_WARPS; ++w) s += red[w][row][col];
  if (n0 + col < ncols) c[(size_t)row * ncols + n0 + col] = s;
}

// out int8[i] = in u32[i] & 15: four words in, one packed register out
__global__ void u32_to_int8_kernel(const uint4* __restrict__ in,
                                   uint32_t* __restrict__ out, int count4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count4) return;
  const uint4 w = in[i];
  const uint32_t lo = __byte_perm(w.x & 15u, w.y & 15u, 0x0040);
  const uint32_t hi = __byte_perm(w.z & 15u, w.w & 15u, 0x0040);
  out[i] = __byte_perm(lo, hi, 0x5410);
}

// one mask serves every sub-word of the register: 0x000F000F for two uint16,
// 0x0F0F0F0F for four uint8
__global__ void shift_and_kernel(const uint32_t* __restrict__ in,
                                 uint32_t* __restrict__ out, int count,
                                 uint32_t mask) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) out[i] = (in[i] >> 4) & mask;
}

// in u32 [k, n] -> out u16 [2k, n]: element j of the register to row 2k + j
__global__ void bitcast_u16_kernel(const uint32_t* __restrict__ in,
                                   uint16_t* __restrict__ out, int k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * n) return;
  const int r = i / n, c = i % n;
  uint32_t w = in[i];
  const ushort2 h = *reinterpret_cast<ushort2*>(&w);
  out[(size_t)(2 * r + 0) * n + c] = h.x;
  out[(size_t)(2 * r + 1) * n + c] = h.y;
}

// in u32 [k, n] -> out int8 [4k, n] of (w & 0x0F0F0F0F): element j of the
// register to row 4k + j
__global__ void bitcast_i8_kernel(const uint32_t* __restrict__ in,
                                  int8_t* __restrict__ out, int k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * n) return;
  const int r = i / n, c = i % n;
  uint32_t lo = in[i] & 0x0F0F0F0Fu;
  const char4 b = *reinterpret_cast<char4*>(&lo);
  out[(size_t)(4 * r + 0) * n + c] = b.x;
  out[(size_t)(4 * r + 1) * n + c] = b.y;
  out[(size_t)(4 * r + 2) * n + c] = b.z;
  out[(size_t)(4 * r + 3) * n + c] = b.w;
}

// packed bytes (two signed nibbles, low first) -> int8, two per byte
__global__ void int4_array_kernel(const uint8_t* __restrict__ in,
                                  int8_t* __restrict__ out, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint8_t p = in[i];
  out[2 * i + 0] = (int8_t)(p << 4) >> 4;
  out[2 * i + 1] = (int8_t)p >> 4;
}

inline unsigned blocks(int count) { return (unsigned)((count + 255) / 256); }

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// a int8 [g, m, k], b int8 [g, k, n] (int4 != 0: packed [g, k, n/2]) ->
// c int32 [g, m, n]; k % 32 == 0, n % 8 == 0, a and b 4-byte aligned. A
// block has one warp for each 64 rows of K (two k-steps a warp), 1 to 8.
int probe_int8_dot(const void* a, const void* b, void* c, int g, int m, int k,
                   int n, int int4, void* stream) {
  if (g < 1 || m < 1 || k < 32 || k % 32 || n < 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 3)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + ID_NB - 1) / ID_NB, (m + 15) / 16, g);
  const int warps = k / 64 < 1 ? 1 : k / 64 < ID_WARPS ? k / 64 : ID_WARPS;
  const int threads = 32 * warps;
  cudaStream_t st = (cudaStream_t)stream;
  if (int4)
    int8_dot_kernel<true><<<grid, threads, 0, st>>>(
        (const int8_t*)a, (const uint8_t*)b, (int*)c, m, k, n);
  else
    int8_dot_kernel<false><<<grid, threads, 0, st>>>(
        (const int8_t*)a, (const uint8_t*)b, (int*)c, m, k, n);
  return (int)cudaGetLastError();
}

// a bf16 [16, k], b bf16 [k, n] -> c f32 [16, n]; k % 16 == 0, n % 8 == 0,
// a and b 16-byte aligned
int probe_bf16_dot(const void* a, const void* b, void* c, int k, int n,
                   void* stream) {
  if (k < 16 || k % 16 || n < 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15)
    return (int)cudaErrorInvalidValue;
  bf16_dot_kernel<<<(n + BF_NB - 1) / BF_NB, 32 * BF_WARPS, 0,
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)c, k, n);
  return (int)cudaGetLastError();
}

// in u32 [count] -> out int8 [count]; count % 4 == 0
int probe_u32_to_int8(const void* in, void* out, int count, void* stream) {
  if (count % 4) return (int)cudaErrorInvalidValue;
  u32_to_int8_kernel<<<blocks(count / 4), 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint32_t*)out, count / 4);
  return (int)cudaGetLastError();
}

// (v >> 4) & 15 on `count` sub-words of `width` bytes (1 or 2)
int probe_shift_and(const void* in, void* out, int count, int width,
                    void* stream) {
  const int per = 4 / width;
  if ((width != 1 && width != 2) || count % per)
    return (int)cudaErrorInvalidValue;
  shift_and_kernel<<<blocks(count / per), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, count / per,
      width == 2 ? 0x000F000Fu : 0x0F0F0F0Fu);
  return (int)cudaGetLastError();
}

// in u32 [k, n] -> out u16 [2k, n] (width 2) or int8 [4k, n] of the low
// nibbles (width 1)
int probe_bitcast(const void* in, void* out, int k, int n, int width,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (width == 2)
    bitcast_u16_kernel<<<blocks(k * n), 256, 0, st>>>(
        (const uint32_t*)in, (uint16_t*)out, k, n);
  else if (width == 1)
    bitcast_i8_kernel<<<blocks(k * n), 256, 0, st>>>(
        (const uint32_t*)in, (int8_t*)out, k, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// in packed bytes [count] -> out int8 [2 * count]
int probe_int4_array(const void* in, void* out, int count, void* stream) {
  int4_array_kernel<<<blocks(count), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (int8_t*)out, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
