// Paged flash-decode (one query token per sequence) over the page pool.
//
// Replaces: exllamav2_tpu/ops/paged_attn.py:paged_decode_attention (the
// Pallas kernel at paged_attn.py:232).
//
// Function: for batch row b with valid length n = valid_lens[b] and query
// head hq = h*G + g (G query heads per KV head h), over the live positions
// pos of the sequence (pos < n, and pos >= n - window when window > 0),
// found through block_table[b, pos / page] of the pool
// [L, Hkv, P*page, D'] (K and V each bf16, fp8 e5m2, q8 or q4 with bf16
// group scales [L, Hkv, P*page, D/32]):
//   k, v   = dequant(row) rounded to bf16 (q8: (u8 - 128) * s, q4: nibble
//            - 8 times s; element j of a q4 row is the low nibble of byte j
//            for j < D/2, else the high nibble of byte j - D/2)
//   s[pos] = (sum_d f32(q[d]) * k[pos, d]) * scale, then tanh softcap
//   per page of rows, in order:  m' = max(m, max_page s), a = exp(m - m'),
//            p = exp(s - m'), l = a*l + sum p, acc = a*acc + bf16(p) . v
//   out    = acc / (l == 0 ? 1 : l)                       (f32 [B, Hq, D])
// These are the rounding points of the Pallas kernel (paged_attn.py:151-184):
// kernel and plain version (ops/paged_attn.py) differ in summation order
// only. The inverse Hadamard of the q4/q8 kinds stays outside (the caller
// pre-rotates q and post-rotates the output).
//
// Bound on the H100: memory. Every live K and V row is read once (bf16, D
// 128: 512 B per row and head; q4: 128 B + 8 B of scales) for 4*G flops per
// element, so the least time is those bytes over 3.35 TB/s (serving, 16
// sequences of 151 rows, 32 KV heads: 39.7 MB per layer, 11.9 us).
//
// Design:
//   * one block of 256 threads per (sequence, KV head) serves its G query
//     heads, so every row is read once for all of them; the block walks its
//     live pages through the block table and skips pages past the valid
//     length or wholly before the window (dead-page skip), and rows outside
//     [n - window, n) inside a live page are never loaded: masking goes by
//     position, never by page index (page 0 is the null page of pad rows);
//   * staging: the live rows of a page (K, V and their scales) are copied
//     into shared memory with cp.async, all requests issued before any is
//     waited on, so a page costs one memory latency. When K and V of a page
//     exceed 160 KB (bf16 at D = 256) V is staged again after the page's
//     softmax. K rows sit 16 bytes apart beyond their length, so the lanes
//     of a warp read 32 different rows without bank conflicts;
//   * scores: one thread per row (a page has at most 256 rows), 16-byte
//     chunks of the row dequantized in registers and dotted with q for all G
//     heads: no cross-lane reduction;
//   * softmax: the page's max is taken over all its scores before any
//     exponent, so p rounds to bf16 at the reference's point;
//   * P.V: each thread owns one element d of the head and a slice of the
//     page's rows (256 / D row groups), accumulates the G heads in registers
//     and the row groups are summed once at the end;
//   * G is a template bucket (1, 4 or 16 heads per KV head) so the per-head
//     loops unroll to what the model needs.
// Later work: split the pages of one sequence across blocks (flash-decoding;
// batch 1 fills Hkv of 132 SMs), double-buffer the next page's copy behind
// the current page's math, tensor-core dots for large G.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PAGE = 256;       // rows per page (<= THREADS)
constexpr int MAX_G = 16;           // query heads per KV head
constexpr int MAX_GD = 2048;        // G * D
constexpr int STAGE_BYTES = 160 * 1024;   // K (+ V) rows staged per chunk
constexpr int MAX_STAGE = STAGE_BYTES + 2 * 4352;  // + two scale buffers
constexpr float NEG = -1e30f;

enum Kind { BF16 = 0, FP8 = 1, Q8 = 2, Q4 = 3 };

__host__ __device__ constexpr int row_bytes(int k, int d) {
  return k == BF16 ? 2 * d : (k == Q4 ? d / 2 : d);
}

struct Args {
  const __nv_bfloat16* q;           // [B, Hq, D]
  const uint8_t* k;                 // pool bases [L, Hkv, rows, D']
  const uint8_t* v;
  const __nv_bfloat16* ks;          // [L, Hkv, rows, D/32] or null
  const __nv_bfloat16* vs;
  const int* bt;                    // [B, pw]
  const int* vl;                    // [B]
  int layer, hkv, g, d, rows, ps, pw, window;
  float scale, softcap, inv_softcap;
  float* out;                       // [B, Hq, D]
  // staging in dynamic shared memory: tr rows per chunk; whole: K and V
  // of a page fit together (else V is staged after the page's softmax)
  int tr, whole, koff, voff, ksoff, vsoff;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Start copying `nrows` rows of `rb` bytes (a multiple of 16, 16-byte
// aligned) from device memory to shared memory rows `ds` bytes apart.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int nrows, int rb, int ds) {
  const int per = rb / 16;
  for (int i = threadIdx.x; i < nrows * per; i += THREADS) {
    const int r = i / per, c = i - r * per;
    cp_async16(dst + r * ds + c * 16, src + (size_t)i * 16);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float rbf(float x) {     // round to bf16
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float fp8_val(uint32_t b) {
  const __half_raw h =
      __nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E5M2);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int j) {
  const uint32_t word = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
  return (word >> (8 * (j & 3))) & 255u;
}

// part[g] += q[g] . k over the 16-byte chunk `c` of a staged K row
// (dequantized and rounded to bf16 first). srow: the row's group scales.
template <int KK, int GB>
__device__ __forceinline__ void dot_chunk(const uint4& w, int c, int D,
                                          int G, const float* qs,
                                          const __nv_bfloat16* srow,
                                          float* part) {
  if constexpr (KK == BF16) {
    float x[8];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(ws[j] << 16);
      x[2 * j + 1] = __uint_as_float(ws[j] & 0xffff0000u);
    }
    const int e0 = 8 * c;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float4* qv = reinterpret_cast<const float4*>(qs + g * D + e0);
        const float4 a = qv[0], b = qv[1];
        float s = part[g];
        s = fmaf(a.x, x[0], s); s = fmaf(a.y, x[1], s);
        s = fmaf(a.z, x[2], s); s = fmaf(a.w, x[3], s);
        s = fmaf(b.x, x[4], s); s = fmaf(b.y, x[5], s);
        s = fmaf(b.z, x[6], s); s = fmaf(b.w, x[7], s);
        part[g] = s;
      }
    }
  } else if constexpr (KK == FP8 || KK == Q8) {
    const int e0 = 16 * c;
    float sc = 0.f;
    if constexpr (KK == Q8) sc = __bfloat162float(srow[e0 >> 5]);
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t b = byte_of(w, j);
      if constexpr (KK == FP8) x[j] = fp8_val(b);
      else x[j] = rbf((float)((int)b - 128) * sc);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float4* qv = reinterpret_cast<const float4*>(qs + g * D + e0);
        float s = part[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = qv[i];
          s = fmaf(a.x, x[4 * i], s); s = fmaf(a.y, x[4 * i + 1], s);
          s = fmaf(a.z, x[4 * i + 2], s); s = fmaf(a.w, x[4 * i + 3], s);
        }
        part[g] = s;
      }
    }
  } else {                                    // Q4: bytes 16c .. 16c + 15
    const int e0 = 16 * c, e1 = e0 + D / 2;
    const float s_lo = __bfloat162float(srow[e0 >> 5]);
    const float s_hi = __bfloat162float(srow[e1 >> 5]);
    float lo[16], hi[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t b = byte_of(w, j);
      lo[j] = rbf((float)((int)(b & 15u) - 8) * s_lo);
      hi[j] = rbf((float)((int)(b >> 4) - 8) * s_hi);
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float4* qa = reinterpret_cast<const float4*>(qs + g * D + e0);
        const float4* qb = reinterpret_cast<const float4*>(qs + g * D + e1);
        float s = part[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = qa[i], b = qb[i];
          s = fmaf(a.x, lo[4 * i], s); s = fmaf(a.y, lo[4 * i + 1], s);
          s = fmaf(a.z, lo[4 * i + 2], s); s = fmaf(a.w, lo[4 * i + 3], s);
          s = fmaf(b.x, hi[4 * i], s); s = fmaf(b.y, hi[4 * i + 1], s);
          s = fmaf(b.z, hi[4 * i + 2], s); s = fmaf(b.w, hi[4 * i + 3], s);
        }
        part[g] = s;
      }
    }
  }
}

// Element dd of a staged V row, dequantized and rounded to bf16.
template <int KIND>
__device__ __forceinline__ float v_elem(const uint8_t* row,
                                        const __nv_bfloat16* srow, int dd,
                                        int d) {
  if constexpr (KIND == BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[dd]);
  if constexpr (KIND == FP8) return fp8_val(row[dd]);
  const float s = __bfloat162float(srow[dd >> 5]);
  if constexpr (KIND == Q8) return rbf((float)((int)row[dd] - 128) * s);
  const int half = d / 2;
  const uint32_t b = row[dd < half ? dd : dd - half];
  const uint32_t nib = dd < half ? (b & 15u) : (b >> 4);
  return rbf((float)((int)nib - 8) * s);
}

template <int KK, int VK, int GB>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(const Args a) {
  __shared__ __align__(16) float qs[MAX_GD];
  __shared__ float ps[MAX_G * MAX_PAGE];    // scores, then p; final sums
  __shared__ float m_run[MAX_G], l_run[MAX_G], alpha[MAX_G];
  extern __shared__ __align__(16) uint8_t stage_buf[];
  uint8_t* kbuf = stage_buf + a.koff;
  uint8_t* vbuf = stage_buf + a.voff;
  const __nv_bfloat16* ksbuf =
      reinterpret_cast<const __nv_bfloat16*>(stage_buf + a.ksoff);
  const __nv_bfloat16* vsbuf =
      reinterpret_cast<const __nv_bfloat16*>(stage_buf + a.vsoff);

  const int b = blockIdx.x / a.hkv, h = blockIdx.x % a.hkv;
  const int G = a.g, D = a.d, GD = G * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = a.hkv * G;

  const __nv_bfloat16* qp = a.q + ((size_t)b * hq + (size_t)h * G) * D;
  for (int i = tid; i < GD; i += THREADS) qs[i] = __bfloat162float(qp[i]);
  if (tid < G) { m_run[tid] = NEG; l_run[tid] = 0.f; }

  const size_t head = (size_t)a.layer * a.hkv + h;
  const int kbytes = row_bytes(KK, D), vbytes = row_bytes(VK, D);
  const int kstride = kbytes + 16;          // staged K row pitch
  const int kchunks = kbytes / 16;
  const int ng = D / 32, sbytes = 2 * ng;   // scale bytes per row
  const uint8_t* kbase = a.k + head * a.rows * kbytes;
  const uint8_t* vbase = a.v + head * a.rows * vbytes;
  const uint8_t* ksbase =
      KK >= Q8 ? reinterpret_cast<const uint8_t*>(a.ks) + head * a.rows * sbytes
               : nullptr;
  const uint8_t* vsbase =
      VK >= Q8 ? reinterpret_cast<const uint8_t*>(a.vs) + head * a.rows * sbytes
               : nullptr;

  const int n = a.vl[b];
  const int lo_abs = a.window > 0 ? max(n - a.window, 0) : 0;
  const int p_first = lo_abs / a.ps;
  const int p_end = n > 0 ? min((n - 1) / a.ps + 1, a.pw) : 0;

  // P.V ownership: element dd of the head, row group rg of RG
  const int RG = THREADS / D;
  const int rg = tid / D, dd = tid % D;
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;

  for (int p = p_first; p < p_end; ++p) {
    const int start = p * a.ps;
    const int lo = max(lo_abs - start, 0), hi = min(n - start, a.ps);
    const size_t row0 = (size_t)a.bt[(size_t)b * a.pw + p] * a.ps;

    // ---- scores of rows [lo, hi) into ps[g][r], a chunk of tr rows at a
    // time staged in shared memory (K, with V too when the page fits)
    for (int c0 = lo; c0 < hi; c0 += a.tr) {
      const int c1 = min(c0 + a.tr, hi);
      const int c0a = c0 & ~7, c1a = (c1 + 7) & ~7;
      __syncthreads();                        // the buffers are free
      stage(kbuf, kbase + (row0 + c0) * kbytes, c1 - c0, kbytes, kstride);
      if constexpr (KK >= Q8)
        stage(stage_buf + a.ksoff, ksbase + (row0 + c0a) * sbytes, 1,
              (c1a - c0a) * sbytes, 0);
      if (a.whole) {
        stage(vbuf, vbase + (row0 + c0) * vbytes, 1, (c1 - c0) * vbytes, 0);
        if constexpr (VK >= Q8)
          stage(stage_buf + a.vsoff, vsbase + (row0 + c0a) * sbytes, 1,
                (c1a - c0a) * sbytes, 0);
      }
      stage_wait();
      __syncthreads();
      const int r = c0 + tid;                 // one row per thread
      if (r < c1) {
        const uint4* kr =
            reinterpret_cast<const uint4*>(kbuf + (size_t)tid * kstride);
        const __nv_bfloat16* sr = ksbuf + (r - c0a) * ng;
        float part[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) part[g] = 0.f;
        for (int c = 0; c < kchunks; ++c)
          dot_chunk<KK, GB>(kr[c], c, D, G, qs, sr, part);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            float s = part[g] * a.scale;
            if (a.softcap > 0.f) s = tanhf(s * a.inv_softcap) * a.softcap;
            ps[g * MAX_PAGE + r] = s;
          }
        }
      }
    }
    __syncthreads();

    // ---- page softmax statistics; p rounded to bf16 in place
    for (int g = warp; g < G; g += WARPS) {
      float* sg = ps + g * MAX_PAGE;
      float mx = NEG;
      for (int r = lo + lane; r < hi; r += 32) mx = fmaxf(mx, sg[r]);
      const float m_prev = m_run[g];
      const float m_next = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lo + lane; r < hi; r += 32) {
        const float pr = expf(sg[r] - m_next);
        sum += pr;
        sg[r] = rbf(pr);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_next);
        alpha[g] = al;
        l_run[g] = l_run[g] * al + sum;
        m_run[g] = m_next;
      }
    }
    __syncthreads();

    // ---- acc = alpha * acc + p . v over this thread's rows
    if (rg < RG) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G) acc[g] *= alpha[g];
    }
    for (int c0 = lo; c0 < hi; c0 += a.tr) {
      const int c1 = min(c0 + a.tr, hi);
      const int c0a = c0 & ~7, c1a = (c1 + 7) & ~7;
      if (!a.whole) {                         // V was not staged with K
        __syncthreads();
        stage(vbuf, vbase + (row0 + c0) * vbytes, 1, (c1 - c0) * vbytes, 0);
        if constexpr (VK >= Q8)
          stage(stage_buf + a.vsoff, vsbase + (row0 + c0a) * sbytes, 1,
                (c1a - c0a) * sbytes, 0);
        stage_wait();
        __syncthreads();
      }
      if (rg < RG) {
#pragma unroll 4
        for (int r = c0 + rg; r < c1; r += RG) {
          const float vv = v_elem<VK>(vbuf + (size_t)(r - c0) * vbytes,
                                      vsbuf + (r - c0a) * ng, dd, D);
#pragma unroll
          for (int g = 0; g < GB; ++g)
            if (g < G) acc[g] = fmaf(ps[g * MAX_PAGE + r], vv, acc[g]);
        }
      }
    }
  }
  __syncthreads();

  // ---- sum the row groups, normalize
  if (rg < RG) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) ps[(rg * G + g) * D + dd] = acc[g];
  }
  __syncthreads();
  float* op = a.out + ((size_t)b * hq + (size_t)h * G) * D;
  for (int o = tid; o < GD; o += THREADS) {
    const int g = o / D, e = o % D;
    float s = 0.f;
    for (int r = 0; r < RG; ++r) s += ps[(r * G + g) * D + e];
    const float l = l_run[g];
    op[o] = s / (l == 0.f ? 1.f : l);
  }
}

template <int KK, int VK, int GB>
int launch(const Args& a, int blocks, int smem, cudaStream_t st) {
  static bool configured = false;             // opt in to > 48 KB once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<KK, VK, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_STAGE);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  paged_attn_kernel<KK, VK, GB><<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KK, int VK>
int launch_g(const Args& a, int blocks, int smem, cudaStream_t st) {
  if (a.g == 1) return launch<KK, VK, 1>(a, blocks, smem, st);
  if (a.g <= 4) return launch<KK, VK, 4>(a, blocks, smem, st);
  return launch<KK, VK, 16>(a, blocks, smem, st);
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [B, Hq, D] bf16; k, v pools [L, Hkv, rows, D'] (contiguous, 16-byte
// aligned) of kinds kk, vk (0 bf16, 1 fp8 e5m2, 2 q8, 3 q4); ks, vs their
// bf16 scales [L, Hkv, rows, D/32] (null for bf16 / fp8, else 16-byte
// aligned); block_table [B, pw] and valid_lens [B] int32; out [B, Hq, D] f32.
// Requires D % 32 == 0, D <= 256, 1 <= G <= 16, G * D <= 2048, page <= 256
// and a multiple of 16, and the supported kind pairs (bf16, bf16),
// (fp8, fp8), (q8, q8), (q4, q4), (q8, q4). Returns the cudaError_t of the
// launch (0 on success).
int paged_decode_attention(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* vl, int layer, int batch, int hkv,
                           int g, int d, int rows, int page, int pw,
                           float scale, float softcap, int window, int kk,
                           int vk, void* out, void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (d % 32 || d > 256 || g < 1 || g > MAX_G || g * d > MAX_GD ||
      page < 16 || page > MAX_PAGE || page % 16 || batch < 1 || hkv < 1 ||
      pw < 1 || kk < BF16 || kk > Q4 || vk < BF16 || vk > Q4 ||
      misaligned(k) || misaligned(v) ||
      (kk >= Q8 && (ks == nullptr || misaligned(ks))) ||
      (vk >= Q8 && (vs == nullptr || misaligned(vs))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)v;
  a.ks = (const __nv_bfloat16*)ks;
  a.vs = (const __nv_bfloat16*)vs;
  a.bt = (const int*)bt;
  a.vl = (const int*)vl;
  a.layer = layer; a.hkv = hkv; a.g = g; a.d = d; a.rows = rows;
  a.ps = page; a.pw = pw; a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_softcap = softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f;
  a.out = (float*)out;
  // staging layout: a page's K and V rows together when they fit in
  // STAGE_BYTES, else chunks of tr rows in one buffer (K, then V)
  const int kp = row_bytes(kk, d) + 16, vb = row_bytes(vk, d);
  const int sb = ((page + 16) * (d / 16) + 15) & ~15;   // one scale buffer
  if (page * (kp + vb) <= STAGE_BYTES) {
    a.whole = 1; a.tr = page;
    a.koff = 0; a.voff = page * kp;
    a.ksoff = a.voff + page * vb;
  } else {
    a.whole = 0;
    a.tr = min(page, (STAGE_BYTES / max(kp, vb)) & ~15);
    a.koff = a.voff = 0;
    a.ksoff = a.tr * max(kp, vb);
  }
  a.vsoff = a.ksoff + sb;
  const int smem = a.vsoff + sb;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = batch * hkv;
  if (kk == BF16 && vk == BF16) return launch_g<BF16, BF16>(a, blocks, smem, st);
  if (kk == FP8 && vk == FP8) return launch_g<FP8, FP8>(a, blocks, smem, st);
  if (kk == Q8 && vk == Q8) return launch_g<Q8, Q8>(a, blocks, smem, st);
  if (kk == Q4 && vk == Q4) return launch_g<Q4, Q4>(a, blocks, smem, st);
  if (kk == Q8 && vk == Q4) return launch_g<Q8, Q4>(a, blocks, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
