// G1: the GPTQ row recursion of one scale group, for the EXL2 converter.
//
// Replaces: no Pallas kernel. The reference runs this loop as a
// lax.fori_loop inside one jitted call (exllamav2_tpu/convert/gptq.py:202
// _gptq_quant_range, rows :218-229); eager PyTorch would spend about eight
// launches a row on it, so the port gives it one launch a group (the
// upstream project's cuda/quantize.cu quantize_range does the same).
//
// Function: rows [a, a+blk) of w [K, N] f32 (row stride ldw), U the upper
// Cholesky factor of H^-1 [K, K] f32 (row stride ldu), scale [N] f32. For
// i = 0 .. blk-1, every column c:
//   q[i]   = clamp(rint(w_i / scale + qzero), 0, maxq)     (uint16 out)
//   dq[i]  = (q[i] - qzero) * scale
//   err[i] = (w_i - dq[i]) / U[a+i, a+i]
//   w_j    = w_j - err[i] * U[a+i, a+j]       for j = i+1 .. blk-1
// with w_i the row as the earlier rows of the group left it. Every
// operation is rounded on its own (__fmul_rn, __fsub_rn, IEEE division: no
// contraction into a fused multiply-add), in the order of the plain loop
// (convert/gptq.py gptq_rows_plain), so the two agree bit for bit. w is
// read, not written; the caller applies the group's errors to the later
// rows with one f32 product.
//
// Bound on the H100: launch and latency. The bytes a group must move are
// w in (4 B) and q, dq, err out (2 + 4 + 4 B) for blk x N, plus U's block:
// 4.9 MB at blk 32, N 11008, 1.5 us at 3.35 TB/s. The recursion is
// sequential in i; each column's chain is blk * (blk - 1) / 2 dependent-free
// updates, 496 at blk 32.
//
// Design: the columns are independent, so a thread owns one column and
// keeps its blk rows in registers (templates of 32, 64 and 128 rows, loops
// unrolled so the array stays in registers). The block stages U's
// blk x blk block in shared memory (4 KB at 32 rows, 64 KB at 128), where
// every thread of a warp reads the same element: a broadcast. 64 threads a
// block, so a 4096-column matrix spreads over 64 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;

template <int BLK>
__global__ void __launch_bounds__(THREADS)
gptq_rows_kernel(const float* __restrict__ w, long long ldw,
                 const float* __restrict__ u, long long ldu,
                 const float* __restrict__ scale, float qzero, float maxq,
                 int a, int blk, int n, uint16_t* __restrict__ q,
                 float* __restrict__ dq, float* __restrict__ err) {
  extern __shared__ float hs[];                // [BLK][BLK], U[a+i][a+j]
  for (int t = threadIdx.x; t < BLK * BLK; t += THREADS) {
    const int i = t / BLK, j = t % BLK;
    hs[t] = (i < blk && j < blk) ? u[(long long)(a + i) * ldu + a + j] : 0.f;
  }
  __syncthreads();
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= n) return;
  const float s = scale[col];
  float wb[BLK];
#pragma unroll
  for (int i = 0; i < BLK; ++i)
    wb[i] = i < blk ? w[(long long)(a + i) * ldw + col] : 0.f;
#pragma unroll
  for (int i = 0; i < BLK; ++i) {
    if (i < blk) {
      const float wi = wb[i];
      const float qi =
          fminf(fmaxf(rintf(__fadd_rn(__fdiv_rn(wi, s), qzero)), 0.f), maxq);
      const float dqi = __fmul_rn(__fsub_rn(qi, qzero), s);
      const float e = __fdiv_rn(__fsub_rn(wi, dqi), hs[i * BLK + i]);
      const long long o = (long long)i * n + col;
      q[o] = (uint16_t)qi;
      dq[o] = dqi;
      err[o] = e;
#pragma unroll
      for (int j = i + 1; j < BLK; ++j)
        wb[j] = __fsub_rn(wb[j], __fmul_rn(e, hs[i * BLK + j]));
    }
  }
}

template <int BLK>
cudaError_t launch(const float* w, long long ldw, const float* u,
                   long long ldu, const float* scale, float qzero,
                   float maxq, int a, int blk, int n, uint16_t* q, float* dq,
                   float* err, cudaStream_t st) {
  constexpr int SMEM = BLK * BLK * (int)sizeof(float);
  static bool opted_in = false;          // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gptq_rows_kernel<BLK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((n + THREADS - 1) / THREADS);
  gptq_rows_kernel<BLK><<<grid, THREADS, SMEM, st>>>(
      w, ldw, u, ldu, scale, qzero, maxq, a, blk, n, q, dq, err);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// w f32 rows a .. a+blk-1 at row stride ldw (unit column stride), u f32
// [K, K] at row stride ldu, scale f32 [n]; q uint16, dq and err f32, each
// [blk, n] contiguous. tpl is the template (32, 64 or 128 rows), at least
// blk. Returns the cudaError_t of the launch (0 on success).
int gptq_rows(const void* w, long long ldw, const void* u, long long ldu,
              const void* scale, float qzero, float maxq, int a, int blk,
              int n, int tpl, void* q, void* dq, void* err, void* stream) {
  if (!w || !u || !scale || !q || !dq || !err || a < 0 || blk < 1 ||
      blk > tpl || n < 1 || ldw < n || ldu < a + blk)
    return (int)cudaErrorInvalidValue;
  const float* wf = (const float*)w;
  const float* uf = (const float*)u;
  const float* sf = (const float*)scale;
  uint16_t* qo = (uint16_t*)q;
  float* dqo = (float*)dq;
  float* eo = (float*)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tpl) {
    case 32:
      return (int)launch<32>(wf, ldw, uf, ldu, sf, qzero, maxq, a, blk, n,
                             qo, dqo, eo, st);
    case 64:
      return (int)launch<64>(wf, ldw, uf, ldu, sf, qzero, maxq, a, blk, n,
                             qo, dqo, eo, st);
    case 128:
      return (int)launch<128>(wf, ldw, uf, ldu, sf, qzero, maxq, a, blk, n,
                              qo, dqo, eo, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
