// The int8 / int4 dot of csrc/probe_features.cu (probe_int8_dot) in a second
// design, built and timed beside it by tools/int8_dot_sweep.py: the same
// function, contract, grid, warps and fragment map, with A and B staged in
// shared memory instead of loaded straight into the fragment registers.
//
//   * a block of warps takes a 16-row, 32-column output tile (one warp for
//     each 64 rows of K, 1 to 8); a pass covers 64 rows of K a warp, and
//     warp w takes the pass's k-steps w and w + nw;
//   * every load of a pass is issued before its first mma, as cp.async of A
//     and B rows into shared memory (16-byte pieces where the rows are
//     16-byte aligned, else 4-byte pieces; columns past n and rows past m
//     zero-filled), one wait and one barrier;
//   * lane (g, t) reads a word of columns 4g..4g+3 (int4: their 16 bits)
//     from each of its eight rows of the stage and a byte transpose (prmt)
//     gives four k-consecutive values of one column; int4 puts each nibble
//     in the high half of its byte in the same pass (the sum is shifted back
//     by 4). B's rows are rotated within each group of four (row r at
//     4 (r / 4) + (r + r / 4) % 4) and A's rows padded by 16 bytes, so the
//     fragment reads of a warp hit 32 distinct banks;
//   * the warps' int32 tiles are summed as the direct design sums them
//     (store_tile: in shared memory in warp order, four columns a thread; a
//     block of one warp stores its registers): one launch.

#include <cuda_runtime.h>
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

constexpr int SW_WARPS = 8;                  // warps of a block, at most
constexpr int SW_NB = 32;                    // columns a block
constexpr int SW_CHUNK = SW_WARPS * 64;      // K rows a pass, at most
constexpr int SW_ASTR = SW_CHUNK + 16;       // A stage row stride (bytes)
constexpr int SW_RSTR = SW_NB + 4;          // tile sum row stride (ints)

// global -> shared, `bytes` (16 or 4) a piece; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes, bool v16) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (v16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

// byte b of each of four words, word i in byte i
__device__ __forceinline__ uint32_t byte_of4(uint32_t m0, uint32_t m1,
                                             uint32_t m2, uint32_t m3,
                                             int b) {
  const uint32_t pair = b < 2 ? 0x5140u : 0x7362u;
  const uint32_t x01 = __byte_perm(m0, m1, pair);
  const uint32_t x23 = __byte_perm(m2, m3, pair);
  return __byte_perm(x01, x23, (b & 1) ? 0x7632u : 0x5410u);
}

template <bool INT4>
__device__ __forceinline__ uint32_t b_bytes(uint32_t v) {
  if constexpr (INT4) {
    const uint32_t x = __byte_perm(v, 0u, 0x1100u);   // b0 b0 b1 b1
    return (x & 0xF000F000u) | ((x << 4) & 0x00F000F0u);
  } else {
    return v;
  }
}

// the stage row of B row r: rotated within its group of four
__device__ __forceinline__ int brot(int r) {
  return (r & ~3) | ((r + (r >> 2)) & 3);
}

// the output tile of a block of nw warps: with one warp the lane stores its
// registers; else each warp puts its tile in red[warp] (lane register r of
// n-tile j is row gid + 8 (r >> 1), column 4 (2 tig + (r & 1)) + j, so the
// four n-tiles of one r are four consecutive columns: one 16-byte store,
// rows padded by 4 ints so a quarter warp hits 32 banks) and thread e sums
// columns 4 (e % 8) .. +3 of row e / 8 over the warps in warp order
template <bool INT4>
__device__ __forceinline__ void store_tile(const int (&acc)[4][4],
                                           int (*red)[16][SW_RSTR], int* c,
                                           int m0, int n0, int mrows,
                                           int ncols, int nw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (nw == 1) {
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
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<int4*>(
        &red[warp][gid + 8 * (r >> 1)][4 * (2 * tig + (r & 1))]) =
        make_int4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
  __syncthreads();
  for (int e = threadIdx.x; e < 16 * SW_NB / 4; e += blockDim.x) {
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

template <bool INT4>
__global__ void __launch_bounds__(32 * SW_WARPS)
int8_dot_staged_kernel(const int8_t* __restrict__ a,
                       const uint8_t* __restrict__ b, int* __restrict__ c,
                       int mrows, int kdim, int ncols, int v16) {
  constexpr int BROW = INT4 ? SW_NB / 2 : SW_NB;      // stage bytes a row
  __shared__ __align__(16) int8_t as[16][SW_ASTR];
  __shared__ __align__(16) uint8_t bs[SW_CHUNK][BROW];
  __shared__ __align__(16) int red[SW_WARPS][16][SW_RSTR];
  const int nw = blockDim.x >> 5, chunk = nw * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * SW_NB, m0 = blockIdx.y * 16, g = blockIdx.z;
  const int brow = INT4 ? ncols / 2 : ncols;          // bytes a row of B
  const int piece = v16 ? 16 : 4;
  a += (size_t)g * mrows * kdim;
  b += (size_t)g * kdim * brow;
  int acc[4][4] = {};
  for (int kc = 0; kc < kdim; kc += chunk) {
    const int rows = min(chunk, kdim - kc);
    if (kc) __syncthreads();                 // the last pass's reads done
    const int apr = rows / piece;
    for (int i = threadIdx.x; i < 16 * apr; i += blockDim.x) {
      const int r = i / apr, q = (i % apr) * piece;
      const bool live = m0 + r < mrows;
      cp_async(&as[r][q], live ? a + (size_t)(m0 + r) * kdim + kc + q
                               : (const int8_t*)a,
               live ? piece : 0, v16);
    }
    const int bpr = BROW / piece;
    const int c0 = INT4 ? n0 / 2 : n0;                // first byte of a row
    for (int i = threadIdx.x; i < rows * bpr; i += blockDim.x) {
      const int r = i / bpr, q = (i % bpr) * piece;
      const bool live = c0 + q < brow;
      cp_async(&bs[brot(r)][q],
               live ? b + (size_t)(kc + r) * brow + c0 + q : b,
               live ? piece : 0, v16);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int kk = (warp + s * nw) * 32;
      if (kk >= rows) break;
      uint32_t ra[4], bw[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[2 * h] = *reinterpret_cast<const uint32_t*>(
            &as[gid][kk + 16 * h + 4 * tig]);
        ra[2 * h + 1] = *reinterpret_cast<const uint32_t*>(
            &as[gid + 8][kk + 16 * h + 4 * tig]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint8_t* row = bs[brot(kk + 16 * (i >> 2) + 4 * tig + (i & 3))];
        bw[i] = INT4 ? *reinterpret_cast<const uint16_t*>(row + 2 * gid)
                     : *reinterpret_cast<const uint32_t*>(row + 4 * gid);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t rb[2] = {
            byte_of4(b_bytes<INT4>(bw[0]), b_bytes<INT4>(bw[1]),
                     b_bytes<INT4>(bw[2]), b_bytes<INT4>(bw[3]), j),
            byte_of4(b_bytes<INT4>(bw[4]), b_bytes<INT4>(bw[5]),
                     b_bytes<INT4>(bw[6]), b_bytes<INT4>(bw[7]), j)};
        mma_s8(acc[j], ra, rb);
      }
    }
  }
  store_tile<INT4>(acc, red, c + (size_t)g * mrows * ncols, m0, n0, mrows,
                   ncols, nw);
}

}  // namespace

extern "C" {

// probe_int8_dot's contract: a int8 [g, m, k], b int8 [g, k, n] (int4 != 0:
// packed [g, k, n/2]) -> c int32 [g, m, n]; k % 32 == 0, n % 8 == 0, a and
// b 4-byte aligned
int sweep_int8_dot(const void* a, const void* b, void* c, int g, int m, int k,
                   int n, int int4, void* stream) {
  if (g < 1 || m < 1 || k < 32 || k % 32 || n < 8 || n % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 3)
    return (int)cudaErrorInvalidValue;
  const int brow = int4 ? n / 2 : n;
  const int v16 = !((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) & 15) && brow % 16 == 0;
  const dim3 grid((n + SW_NB - 1) / SW_NB, (m + 15) / 16, g);
  const int warps = k / 64 < 1 ? 1 : k / 64 < SW_WARPS ? k / 64 : SW_WARPS;
  cudaStream_t st = (cudaStream_t)stream;
  if (int4)
    int8_dot_staged_kernel<true><<<grid, 32 * warps, 0, st>>>(
        (const int8_t*)a, (const uint8_t*)b, (int*)c, m, k, n, v16);
  else
    int8_dot_staged_kernel<false><<<grid, 32 * warps, 0, st>>>(
        (const int8_t*)a, (const uint8_t*)b, (int*)c, m, k, n, v16);
  return (int)cudaGetLastError();
}

}  // extern "C"
