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
// past_len is read from device memory (past_len[b * past_len_stride]: one
// position per batch row, or one shared with stride 0), so a captured CUDA
// graph of a decode step replays at every later position of its bucket.
//   out    = sum_pos softmax(s)[pos] * f32(v[pos, :])   (f32 [B, Hq, D])
// The softmax is taken online in f32, which rounds differently from the
// plain version's exp / sum (ops/decode_attn.py).
//
// Bound on the H100: memory. Each attended K and V element (bf16) is read
// once and used for 2*G flops, so the least time is the K+V bytes of the
// attended rows over 3.35 TB/s (B=1, 32 KV heads, D=128, 256 rows: 4.2 MB ->
// 1.25 us). At batch 1 one block per (batch, KV head) fills 32 of the 132
// SMs and walks its rows one tile after another; the time is then latency.
//
// Design (flash-decoding):
//   * the G query heads of a KV head are cut into `chunks` of at most gc
//     heads (gc <= 16 and gc * D <= 2048: ops/decode_attn.head_chunks picks
//     gc = ceil(G / chunks)); a block attends for one chunk and the K/V rows
//     are read once a chunk (three times at 48 query heads on one KV head,
//     where the cache is 1/48 of the query width);
//   * the grid is (batch * hkv * chunks, splits): split i takes cache rows
//     [i * per, (i + 1) * per) of [0, limit). The caller picks splits from
//     `limit` (its bucket), not from past_len (ops/decode_attn.py:
//     split_count: about three blocks per SM, at least 32 rows a split), so
//     the grid is fixed for a bucket. A split whose rows lie wholly outside
//     the attended range [lo, hi) writes an empty partial (m = -inf, l = 0);
//   * K and V are read as 16-byte vectors: a row is D/8 lanes (LPR, rounded
//     up to a power of two), neighbouring lanes on neighbouring addresses, so
//     one warp load covers 32/LPR rows (two at D = 128). Every load of a
//     step (U rows per lane-group) is issued before the first use, the
//     first step's before q is staged and each next step's before the
//     current one is scored;
//   * each lane-group of a warp is a stream with its own online softmax
//     (m, l, acc) for the G query heads; a score is reduced over the LPR
//     lanes that hold the row (16 at D = 128), and the G heads reuse the K
//     registers. Streams merge by shuffles inside the warp, the four warps
//     through shared memory, in fixed order;
//   * with one split the block writes `out`. Otherwise it writes its
//     unnormalised acc [G, D] and (m, l) to f32 scratch; the last block of a
//     (batch, KV head, chunk), found through a counter (the wrapper keeps one
//     counter buffer per stream: device.stream_counters), merges the splits in split
//     order (M = max m_s, L = sum l_s e^(m_s-M), out = sum acc_s e^(m_s-M)
//     / L; the first eight splits' acc loaded beside every (m, l), eight
//     splits a round after that) and sets the counter back to 0. No float atomics: the result does not depend on
//     which block ends last, and the merge costs no second launch.
// The layer's slice of the whole cache [L, B, Hkv, S, D] is addressed through
// strides -- cache[layer] is never copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;           // query heads per KV head
constexpr int MAX_GD = 2048;        // G * D
constexpr int MAX_SPLITS = 64;

struct Args {
  const __nv_bfloat16* q;           // [B, Hq, D]
  const __nv_bfloat16* k;           // cache base, strides below
  const __nv_bfloat16* v;
  long long sl, sb, sh, ss;         // element strides of L, B, Hkv, S
  const int* past_len;              // [B] or [1], stride past_len_stride
  int layer, batch, hkv, g, d, past_len_stride, limit, window, splits, per;
  int gc, chunks;                   // heads of a chunk (the last may hold
                                    // fewer); chunks of a KV head
  float scale, softcap, inv_softcap;
  float* out;                       // [B, Hq, D]
  float* pacc;                      // [splits, B, Hq, D]   (splits > 1)
  float* pml;                       // [splits, B, Hq, 2]   (splits > 1)
  int* count;                       // [B * Hkv * chunks], 0 between launches
};

__device__ __forceinline__ void bf16x8(const uint4 r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One or two query heads a KV head fit 128 registers a thread: four blocks
// per SM keep enough K/V loads in flight on long caches.
template <int LPR, int GMAX>
__global__ void __launch_bounds__(THREADS, GMAX <= 2 ? 4 : 1)
    decode_attn_kernel(const Args a) {
  constexpr int RPW = 32 / LPR;                 // rows per warp load
  constexpr int STREAMS = WARPS * RPW;
  constexpr int U = GMAX >= 8 ? 2 : 4;          // rows per stream per step
  constexpr int STEP = STREAMS * U;
  const float NEG_INF = -INFINITY;
  __shared__ __align__(16) float qs[MAX_GD];
  __shared__ __align__(16) float wacc[WARPS][MAX_GD];
  __shared__ float wm[WARPS][MAX_G], wl[WARPS][MAX_G];
  __shared__ int is_last;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / (a.hkv * a.chunks), h = bh / a.chunks % a.hkv;
  const int c = bh % a.chunks;
  // this block's query heads: c * gc .. c * gc + G - 1 of the KV head's
  const int G = min(a.gc, a.g - c * a.gc), D = a.d, GD = G * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = lane / LPR, d0 = (lane % LPR) * 8;
  const bool active = d0 < D;
  const int hq = a.hkv * a.g;
  const size_t head0 =                                   // first query head
      (size_t)b * hq + (size_t)h * a.g + (size_t)c * a.gc;

  // the caller checks 0 <= past_len < limit on the host; the clamp only
  // keeps every access inside the bucket
  const int past_len =
      min(max(__ldg(a.past_len + b * a.past_len_stride), 0), a.limit - 1);
  const int hi = min(a.limit, past_len + 1);
  const int lo = a.window > 0 ? max(0, past_len - a.window + 1) : 0;
  const int r_lo = max(lo, split * a.per);
  const int r_hi = min(hi, (split + 1) * a.per);

  if (r_lo < r_hi) {
    const size_t base = (size_t)a.layer * a.sl + (size_t)b * a.sb +
                        (size_t)h * a.sh + d0;
    const __nv_bfloat16* kp = a.k + base;
    const __nv_bfloat16* vp = a.v + base;
    const int stream = warp * RPW + seg;
    // K and V rows r0 + u*STREAMS + stream of a step, zero past r_hi
    const auto load = [&](int r0, uint4 (&kr)[U], uint4 (&vr)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int pos = r0 + u * STREAMS + stream;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (pos < r_hi && active) {
          kr[u] = *reinterpret_cast<const uint4*>(kp + (size_t)pos * a.ss);
          vr[u] = *reinterpret_cast<const uint4*>(vp + (size_t)pos * a.ss);
        }
      }
    };
    // the first step's loads are in flight while q is staged, and each
    // step's while the one before it is scored
    uint4 kr[U], vr[U];
    load(r_lo, kr, vr);
    // every q load of the thread before any store: a store to shared memory
    // through a generic pointer would otherwise hold back the next load
    constexpr int QPT =                           // q values a thread stages
        (GMAX * 256 < MAX_GD ? GMAX * 256 : MAX_GD) / THREADS;
    float qv[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int i = tid + j * THREADS;
      qv[j] = i < GD ? __bfloat162float(__ldg(a.q + head0 * D + i)) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j)
      if (tid + j * THREADS < GD) qs[tid + j * THREADS] = qv[j];
    __syncthreads();

    float m[GMAX], l[GMAX], acc[GMAX][8];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }

    for (int r0 = r_lo; r0 < r_hi; r0 += STEP) {
      const bool more = r0 + STEP < r_hi;
      uint4 kn[U], vn[U];
      if (more) load(r0 + STEP, kn, vn);
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) ok[u] = r0 + u * STREAMS + stream < r_hi;
      float s[U][GMAX];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        bf16x8(kr[u], kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g >= G) break;
          float part = 0.f;
          if (active) {
            const float4 q0 = *reinterpret_cast<const float4*>(&qs[g * D + d0]);
            const float4 q1 =
                *reinterpret_cast<const float4*>(&qs[g * D + d0 + 4]);
            part = kf[0] * q0.x + kf[1] * q0.y + kf[2] * q0.z + kf[3] * q0.w +
                   kf[4] * q1.x + kf[5] * q1.y + kf[6] * q1.z + kf[7] * q1.w;
          }
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          float sc = part * a.scale;
          if (a.softcap > 0.f) sc = tanhf(sc * a.inv_softcap) * a.softcap;
          s[u][g] = ok[u] ? sc : NEG_INF;
        }
      }
      float vf[U][8];
#pragma unroll
      for (int u = 0; u < U; ++u) bf16x8(vr[u], vf[u]);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float mx = s[0][g];
#pragma unroll
        for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
        const float m_new = fmaxf(m[g], mx);
        if (m_new == NEG_INF) continue;           // no attended row yet
        const float al = expf(m[g] - m_new);    // exp(-inf) = 0
        float p[U], ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = expf(s[u][g] - m_new);
          ps += p[u];
        }
        l[g] = l[g] * al + ps;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float x = acc[g][e] * al;
#pragma unroll
          for (int u = 0; u < U; ++u) x = fmaf(p[u], vf[u][e], x);
          acc[g][e] = x;
        }
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          kr[u] = kn[u];
          vr[u] = vn[u];
        }
      }
    }

    // merge the RPW streams of the warp: lanes LPR apart hold the same dims
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mm = fmaxf(m[g], mo);
        const float fa = m[g] == NEG_INF ? 0.f : expf(m[g] - mm);
        const float fb = mo == NEG_INF ? 0.f : expf(mo - mm);
        l[g] = l[g] * fa + lo_ * fb;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * fa + ao * fb;
        }
        m[g] = mm;
      }
    }
    if (seg == 0 && active) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        float4* dst = reinterpret_cast<float4*>(&wacc[warp][g * D + d0]);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        wm[warp][g] = m[g];
        wl[warp][g] = l[g];
      }
    }
    __syncthreads();

    // merge the warps in order; one split writes out, else the partial
    for (int o = tid; o < GD; o += THREADS) {
      const int g = o / D;
      float mm = wm[0][g];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mm = fmaxf(mm, wm[w][g]);
      float x = 0.f, ll = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if (wm[w][g] == NEG_INF) continue;
        const float f = expf(wm[w][g] - mm);
        x += wacc[w][o] * f;
        ll += wl[w][g] * f;
      }
      if (a.splits == 1) {
        a.out[head0 * D + o] = x / ll;
      } else {
        const size_t sp = (size_t)split * a.batch * hq + head0;
        a.pacc[sp * D + o] = x;
        if (o % D == 0) {
          a.pml[(sp + g) * 2] = mm;
          a.pml[(sp + g) * 2 + 1] = ll;
        }
      }
    }
    if (a.splits == 1) return;
  } else {
    // no attended row in this split: an empty partial
    const size_t sp = (size_t)split * a.batch * hq + head0;
    for (int g = tid; g < G; g += THREADS) {
      a.pml[(sp + g) * 2] = NEG_INF;
      a.pml[(sp + g) * 2 + 1] = 0.f;
    }
  }

  // the last block of this (batch, KV head, chunk) merges the splits; one thread
  // fences and counts for the block, as a grid barrier does
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(&a.count[bh], 1) == a.splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // the first eight splits' acc and every (m, l) in one round of loads,
  // further splits eight a round; the sums run in split order. wacc is
  // free by now. An empty split's acc was never written: its weight is 0
  // and its value is never added.
  const size_t stride = (size_t)a.batch * hq;
  float* ce = &wacc[0][0];                      // [MAX_SPLITS][MAX_G]
  float* cl = &wacc[0][MAX_SPLITS * MAX_G];     // [MAX_SPLITS][MAX_G]
  constexpr int KO = GMAX >= 4 ? 4 : 1;         // outputs a thread merges
  const auto load_round = [&](int o0, int s0, float (&pv)[KO][8]) {
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k * THREADS;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[k][i] = o < GD && s0 + i < a.splits
            ? __ldcg(&a.pacc[((size_t)(s0 + i) * stride + head0) * D + o])
            : 0.f;
    }
  };
  float first[KO][8];
  load_round(tid, 0, first);
  for (int i = tid; i < a.splits * G; i += THREADS) {
    const int s = i / G, g = i % G;
    const float* ml = &a.pml[((size_t)s * stride + head0 + g) * 2];
    ce[s * MAX_G + g] = __ldcg(ml);
    cl[s * MAX_G + g] = __ldcg(ml + 1);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float mm = NEG_INF;
    for (int s = 0; s < a.splits; ++s) mm = fmaxf(mm, ce[s * MAX_G + g]);
    float ll = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = ce[s * MAX_G + g];
      const float e = ms == NEG_INF ? 0.f : expf(ms - mm);
      ce[s * MAX_G + g] = e;
      ll += cl[s * MAX_G + g] * e;
    }
    wl[0][g] = ll;
  }
  __syncthreads();
  for (int o0 = tid; o0 < GD; o0 += KO * THREADS) {
    float x[KO] = {};
    for (int s0 = 0; s0 < a.splits; s0 += 8) {
      float pv[KO][8];
      if (o0 == tid && s0 == 0) {
#pragma unroll
        for (int k = 0; k < KO; ++k)
#pragma unroll
          for (int i = 0; i < 8; ++i) pv[k][i] = first[k][i];
      } else {
        load_round(o0, s0, pv);
      }
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        const int g = min((o0 + k * THREADS) / D, G - 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = s0 + i < a.splits ? ce[(s0 + i) * MAX_G + g] : 0.f;
          if (e != 0.f) x[k] += pv[k][i] * e;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k * THREADS;
      if (o < GD) a.out[head0 * D + o] = x[k] / wl[0][o / D];
    }
  }
  if (tid == 0) a.count[bh] = 0;
}

template <int LPR>
cudaError_t launch_g(const Args& a, dim3 grid, cudaStream_t st) {
  if (a.gc <= 1)      decode_attn_kernel<LPR, 1><<<grid, THREADS, 0, st>>>(a);
  else if (a.gc <= 2) decode_attn_kernel<LPR, 2><<<grid, THREADS, 0, st>>>(a);
  else if (a.gc <= 4) decode_attn_kernel<LPR, 4><<<grid, THREADS, 0, st>>>(a);
  else if (a.gc <= 8) decode_attn_kernel<LPR, 8><<<grid, THREADS, 0, st>>>(a);
  else               decode_attn_kernel<LPR, 16><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// q [B, Hq, D] bf16 contiguous; k, v bf16 cache bases with element strides
// (sl, sb, sh, ss) and unit stride along D; out [B, Hq, D] f32. With
// splits > 1: pacc [splits, B, Hq, D] and pml [splits, B, Hq, 2] f32
// scratch, count int32 [B * Hkv * chunks] all 0 (left at 0), chunks =
// ceil(g / gc) blocks of at most gc query heads a KV head; split i takes rows
// [i * per, (i + 1) * per), and splits * per >= limit. past_len int32 in
// device memory, row b's at past_len[b * past_len_stride] (stride 0: one
// for every row), each in [0, limit) (checked by the caller: the kernel
// clamps it into that range).
// Requires D % 32 == 0, D <= 256, gc <= 16,
// gc*D <= 2048, splits <= 64, 16-byte aligned K/V rows (ss and the bases
// multiples of 8 elements) and q.
// Returns the cudaError_t of the launch (0 on success).
int decode_attention(const void* q, const void* k, const void* v,
                     long long sl, long long sb, long long sh, long long ss,
                     int layer, int batch, int hkv, int g, int gc, int d,
                     const void* past_len, int past_len_stride, int limit,
                     float scale, float softcap,
                     int window, int splits, int per, void* out, void* pacc,
                     void* pml, void* count, void* stream) {
  if (d % 32 || d > 256 || g < 1 || gc < 1 || gc > MAX_G ||
      gc * d > MAX_GD ||
      !past_len || past_len_stride < 0 || past_len_stride > 1 ||
      limit < 1 || batch < 1 || hkv < 1 ||
      splits < 1 || splits > MAX_SPLITS || per < 1 ||
      (long long)splits * per < limit ||
      (splits > 1 && (!pacc || !pml || !count)) ||
      ss % 8 || sl % 8 || sb % 8 || sh % 8 ||
      (reinterpret_cast<uintptr_t>(k) & 15) ||
      (reinterpret_cast<uintptr_t>(v) & 15))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.sl = sl; a.sb = sb; a.sh = sh; a.ss = ss;
  a.layer = layer; a.batch = batch; a.hkv = hkv; a.g = g; a.d = d;
  a.gc = gc;
  a.chunks = (g + gc - 1) / gc;
  a.past_len = (const int*)past_len;
  a.past_len_stride = past_len_stride;
  a.limit = limit; a.window = window;
  a.splits = splits; a.per = per;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_softcap = softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f;
  a.out = (float*)out;
  a.pacc = (float*)pacc;
  a.pml = (float*)pml;
  a.count = (int*)count;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(batch * hkv * a.chunks, splits);
  if (d <= 32) return (int)launch_g<4>(a, grid, st);
  if (d <= 64) return (int)launch_g<8>(a, grid, st);
  if (d <= 128) return (int)launch_g<16>(a, grid, st);
  return (int)launch_g<32>(a, grid, st);
}

}  // extern "C"
