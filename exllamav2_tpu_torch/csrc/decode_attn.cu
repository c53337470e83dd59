// Decode attention (one query token) over the linear KV cache.
//
// Replaces: exllamav2_tpu/ops/decode_attn.py:decode_attention (the Pallas
// kernel at decode_attn.py:86).
//
// Function: for batch b and query head hq = h*G + g (G query heads per KV
// head h), over cache rows pos < limit of layer `layer`,
//   s[pos] = (sum_d f32(q[d]) * f32(k[pos, d])) * scale
//   s      = tanh(s * (1/softcap)) * softcap            when softcap > 0
//   attend pos <= past_len, and pos > past_len - window when window > 0
//   out    = sum_pos softmax(s)[pos] * f32(v[pos, :])   (f32 [B, Hq, D])
// The softmax is taken online in f32 over tiles of 32 rows, which rounds
// differently from the plain version's exp / sum (ops/decode_attn.py).
//
// Bound on the H100: memory. Each attended K and V element (bf16) is read
// once and used for 2*G flops, so the least time is the K+V bytes of the
// attended rows over 3.35 TB/s (B=1, 32 KV heads, D=128, 256 rows: 4.2 MB ->
// 1.25 us).
//
// Design:
//   * one block of 256 threads per (batch, KV head) serves its G query
//     heads, so every K/V row is read once for all of them;
//   * the layer's slice of the whole cache [L, B, Hkv, S, D] is addressed
//     through strides -- cache[layer] is never copied;
//   * only rows [lo, hi) are visited: hi = min(limit, past_len + 1),
//     lo = past_len - window + 1 with a window; rows outside are masked in
//     the reference and contribute exactly zero;
//   * per tile of 64 rows every K and V load is issued before any is used
//     (each warp's 8 K rows into registers, V as 16-byte loads), so a tile
//     costs one memory latency, not one per row;
//   * each warp scores its rows (a lane slice of D per lane, shuffle
//     reduction), V is staged in shared memory, each warp updates the
//     running max / sum of some query heads, and each thread accumulates its
//     (head, d) outputs in registers.
// Later work: split S across blocks (flash-decoding) -- at B=1 and 32 KV
// heads this kernel fills only 32 of the 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;            // cache rows per tile
constexpr int ROWS = TILE / WARPS;  // rows scored by each warp per tile
constexpr int MAX_G = 16;           // query heads per KV head
constexpr int MAX_GD = 2048;        // G * D
constexpr int MAX_OUT = MAX_GD / THREADS;

struct Args {
  const __nv_bfloat16* q;           // [B, Hq, D]
  const __nv_bfloat16* k;           // cache base, strides below
  const __nv_bfloat16* v;
  long long sl, sb, sh, ss;         // element strides of L, B, Hkv, S
  int layer, hkv, g, past_len, limit, window;
  float scale, softcap, inv_softcap;
  float* out;                       // [B, Hq, D]
};

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

template <int DPL>                  // head_dim = 32 * DPL
__global__ void __launch_bounds__(THREADS) decode_attn_kernel(const Args a) {
  constexpr int D = 32 * DPL;
  constexpr int VEC = 8;            // bf16 per 16-byte load
  __shared__ float qs[MAX_GD];
  __shared__ float ps[MAX_G * TILE];
  __shared__ __align__(16) uint16_t vs[TILE * D];   // bf16 bits of V tile
  __shared__ float m_run[MAX_G], l_run[MAX_G], alpha[MAX_G];

  const int b = blockIdx.x / a.hkv, h = blockIdx.x % a.hkv;
  const int G = a.g, GD = a.g * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq0 = h * G;
  const int hq = a.hkv * G;

  const __nv_bfloat16* qp = a.q + ((size_t)b * hq + hq0) * D;
  for (int i = tid; i < GD; i += THREADS) qs[i] = __bfloat162float(qp[i]);
  if (tid < G) { m_run[tid] = -INFINITY; l_run[tid] = 0.f; }

  const size_t base = (size_t)a.layer * a.sl + (size_t)b * a.sb +
                      (size_t)h * a.sh;
  const __nv_bfloat16* kp = a.k + base;
  const __nv_bfloat16* vp = a.v + base;

  const int hi = min(a.limit, a.past_len + 1);
  const int lo = a.window > 0 ? max(0, a.past_len - a.window + 1) : 0;

  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    // issue every load of the tile before using any: the K rows this warp
    // scores (lane slice of D per row) and this thread's share of V
    float kv[ROWS][DPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int pos = t0 + warp * ROWS + r;
      const __nv_bfloat16* kr = kp + (size_t)pos * a.ss + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) kv[r][e] = 0.f;
      if (pos < hi) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) kv[r][e] = __bfloat162float(kr[e]);
      }
    }
    constexpr int VLOADS = TILE * D / VEC / THREADS;
    uint4 vr[VLOADS];
#pragma unroll
    for (int j = 0; j < VLOADS; ++j) {
      const int i = (tid + j * THREADS) * VEC;
      const int pos = t0 + i / D;
      vr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < hi)
        vr[j] = *reinterpret_cast<const uint4*>(vp + (size_t)pos * a.ss + i % D);
    }

    // scores of this warp's rows for every query head
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int rr = warp * ROWS + r;
      const bool valid = t0 + rr < hi;
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D + lane * DPL;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) part = fmaf(kv[r][e], qg[e], part);
        float s = warp_sum(part) * a.scale;
        if (a.softcap > 0.f) s = tanhf(s * a.inv_softcap) * a.softcap;
        if (lane == 0) ps[g * TILE + rr] = valid ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < VLOADS; ++j)
      *reinterpret_cast<uint4*>(&vs[(tid + j * THREADS) * VEC]) = vr[j];
    __syncthreads();

    // online softmax statistics: warp w takes heads w, w + WARPS, ...;
    // lane l holds rows l and l + 32 of the tile
    for (int g = warp; g < G; g += WARPS) {
      const float s0 = ps[g * TILE + lane], s1 = ps[g * TILE + lane + 32];
      const float m_new = fmaxf(m_run[g], warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[g * TILE + lane] = p0;
      ps[g * TILE + lane + 32] = p1;
      const float tot = warp_sum(p0 + p1);
      if (lane == 0) {
        const float al = expf(m_run[g] - m_new);         // exp(-inf) = 0
        alpha[g] = al;
        l_run[g] = l_run[g] * al + tot;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // accumulate: thread owns outputs o = tid + THREADS * i -> (g, d)
#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int o = tid + THREADS * i;
      if (o < GD) {
        const int g = o / D, d = o % D;
        float x = acc[i] * alpha[g];
        const float* pg = ps + g * TILE;
#pragma unroll 8
        for (int rr = 0; rr < TILE; ++rr) {
          const float vv =
              __bfloat162float(__ushort_as_bfloat16(vs[rr * D + d]));
          x = fmaf(pg[rr], vv, x);
        }
        acc[i] = x;
      }
    }
    __syncthreads();
  }

  float* op = a.out + ((size_t)b * hq + hq0) * D;
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int o = tid + THREADS * i;
    if (o < GD) op[o] = acc[i] / l_run[o / D];
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [B, Hq, D] bf16 contiguous; k, v bf16 cache bases with element strides
// (sl, sb, sh, ss) and unit stride along D; out [B, Hq, D] f32.
// Requires 0 <= past_len < limit, D % 32 == 0, D <= 256, G <= 16,
// G*D <= 2048, 16-byte aligned K/V rows (ss and the bases multiples of 8).
// Returns the cudaError_t of the launch (0 on success).
int decode_attention(const void* q, const void* k, const void* v,
                     long long sl, long long sb, long long sh, long long ss,
                     int layer, int batch, int hkv, int g, int d,
                     int past_len, int limit, float scale, float softcap,
                     int window, void* out, void* stream) {
  if (d % 32 || d > 256 || g < 1 || g > MAX_G || g * d > MAX_GD ||
      past_len < 0 || past_len >= limit || batch < 1 || hkv < 1 ||
      ss % 8 || sl % 8 || sb % 8 || sh % 8 ||
      (reinterpret_cast<uintptr_t>(v) & 15))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.sl = sl; a.sb = sb; a.sh = sh; a.ss = ss;
  a.layer = layer; a.hkv = hkv; a.g = g;
  a.past_len = past_len; a.limit = limit; a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_softcap = softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f;
  a.out = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(batch * hkv);
  switch (d / 32) {
    case 1: decode_attn_kernel<1><<<grid, THREADS, 0, st>>>(a); break;
    case 2: decode_attn_kernel<2><<<grid, THREADS, 0, st>>>(a); break;
    case 3: decode_attn_kernel<3><<<grid, THREADS, 0, st>>>(a); break;
    case 4: decode_attn_kernel<4><<<grid, THREADS, 0, st>>>(a); break;
    case 5: decode_attn_kernel<5><<<grid, THREADS, 0, st>>>(a); break;
    case 6: decode_attn_kernel<6><<<grid, THREADS, 0, st>>>(a); break;
    case 7: decode_attn_kernel<7><<<grid, THREADS, 0, st>>>(a); break;
    case 8: decode_attn_kernel<8><<<grid, THREADS, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
