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
// 1.25 us). The bytes do not grow with G, the work does: 48 query heads on
// one KV head read 1/48 of the cache bytes of 48 KV heads. At batch 1 the
// time is latency: a block walks its rows one tile after another.
//
// Two templates, chosen by the wrapper from the shape alone
// (ops/decode_attn.tile_plan):
//
// The CUDA-core template (G = 1: one query head a KV head, the main path;
// flash-decoding):
//   * the grid is (batch * hkv * head blocks, splits): split i takes rows
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
//     (m, l, acc); a score is reduced over the LPR lanes that hold the row
//     (16 at D = 128). Streams merge by shuffles inside the warp, the four
//     warps through shared memory, in fixed order. Each further head of a
//     KV head would pay its own reduction tree a row, so the mma template
//     below takes G >= 2 (it beat this template at every G >= 2 timed,
//     Gemma-3's G = 2 at D = 256 included: PERF.md), and this one is built
//     for one head only (the entry refuses more).
//
// The mma template (G >= 2): a KV head's query heads are one tensor-core
// tile, its K/V rows read once for all of them.
//   * a block takes (batch, KV head, split) and all G heads of the KV head:
//     ceil(G / 16) m16 tiles of query rows (MT, a template parameter; rows
//     past G are zero and never written), staged once as bf16 in shared
//     memory, their loads issued with past_len's. Up to gqa::MAX_MT = 4
//     tiles (64 heads) a block; past that the heads go to ceil(G / 64)
//     blocks of a KV head (Falcon-7B's 71: two), each reading the rows
//     again: 64 heads' accumulators (32 registers a tile at D = 256) and
//     their merge scratch set that limit;
//   * the split's rows go in tiles of TR = 32 through a ring of 16-byte
//     cp.async copies into shared memory (K and V rows of stride D + 8, so
//     the eight rows an ldmatrix phase reads lie on distinct bank groups;
//     rows past the attended end zero-filled): three stages, two tiles in
//     flight while one is used; two stages at D = 256, whose 101 KB of
//     three would leave one block an SM;
//   * scores: S = Q.K^T by mma.sync.m16n8k16 (bf16 in, f32 out: the
//     products of the bf16 q and k are exact; the tensor core adds them
//     into the f32 accumulator in its own order and rounding, which is not
//     an f32 dot's: where the scores are large, as on StarCoder-15B's
//     random layers (up to 4e4, runner-ups ~2 below the max), the output
//     can lie further from an f64 evaluation than the f32 plain version's;
//     both distances are measured on that path, PERF.md), warp w scoring
//     the tile's rows 8w .. 8w + 7 (one n8 tile, B fragments by ldmatrix)
//     for every m-tile;
//     scale, softcap and the position mask on the accumulator fragments. A
//     row's max over the warp's 8 columns takes two quad shuffles; the
//     four warps' maxima meet in shared memory (read in warp order, so
//     every warp holds the same m). Scoring the whole tile in every warp
//     instead needed no exchange but took 1.6x as long at 48 heads
//     (PERF.md);
//   * online softmax on the fragments: alpha = e^(m - m'), p = e^(s - m').
//     The reference keeps p in f32 (decode_attn.py:64-79), so p enters
//     P.V as hi = bf16(p) and lo = bf16(p - hi), two mma a k-step: p keeps
//     16 bits (|p - hi - lo| <= 2^-16 p), 1.5e-5 of max |v| at most
//     against the 1e-4 gate. The hi and lo tiles [16 MT][TR] go through
//     shared memory (a second barrier), from which every warp takes its A
//     fragments by ldmatrix;
//   * P.V: warp w owns output columns [w*D/4, (w+1)*D/4) (D/32 n8 tiles,
//     MT x D/8 f32 accumulators a lane), V by ldmatrix.trans. The row sums
//     are kept per lane and added over the quad, then over the warps in
//     order;
//   * a split's partial is G x D floats: the wrapper's split_count takes at
//     least max(64, 4 G) rows a split (ops/decode_attn.mma_split_rows), so
//     the one block that merges reads about as much as the splits' K/V; it
//     merges 4 float4 outputs a thread with eight splits' loads in flight.
//   Registers and shared memory of each instantiation: PERF.md (nvcc
//   -Xptxas -v in chip_smoke.py's build phase).
//
// Both templates: with one split the block writes `out`. Otherwise it
// writes its unnormalised acc [G, D] and (m, l) to f32 scratch; the last
// block of a (batch, KV head, head block), found through a counter (the
// wrapper keeps one counter buffer per stream: device.stream_counters),
// merges the splits in split order (M = max m_s, L = sum l_s e^(m_s-M),
// out = sum acc_s e^(m_s-M) / L) and sets the counter back to 0. No float
// atomics: the result does not depend on which block ends last, and the
// merge costs no second launch.
// The layer's slice of the whole cache [L, B, Hkv, S, D] is addressed through
// strides -- cache[layer] is never copied.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "gqa_tile.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 1;            // query heads a block of the CUDA-core
                                    // template (G >= 2 take the mma one)
constexpr int MAX_GD = MAX_G * 256; // G * D
constexpr int MAX_SPLITS = 64;
constexpr int MAX_SMEM = 227 * 1024;    // dynamic shared memory a block

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

// One query head a KV head fits 128 registers a thread: four blocks per SM
// keep enough K/V loads in flight on long caches.
template <int LPR>
__global__ void __launch_bounds__(THREADS, 4)
    decode_attn_kernel(const Args a) {
  constexpr int RPW = 32 / LPR;                 // rows per warp load
  constexpr int STREAMS = WARPS * RPW;
  constexpr int U = 4;                          // rows per stream per step
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
    constexpr int QPT = MAX_GD / THREADS;         // q values a thread stages
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

    float m[MAX_G], l[MAX_G], acc[MAX_G][8];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
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
      float s[U][MAX_G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[8];
        bf16x8(kr[u], kf);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
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
      for (int g = 0; g < MAX_G; ++g) {
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
      for (int g = 0; g < MAX_G; ++g) {
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
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float4* dst = reinterpret_cast<float4*>(&wacc[warp][g * D + d0]);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
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
  constexpr int KO = 1;                         // outputs a thread merges
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
cudaError_t launch_core(const Args& a, dim3 grid, cudaStream_t st) {
  decode_attn_kernel<LPR><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}


// --------------------------------------------------------------- mma template

constexpr int TR = 32;              // cache rows a tile
// tiles of the cp.async ring: two at D = 256, whose tiles are twice as
// large, three below
__host__ __device__ constexpr int nstage(int nt) { return nt >= 8 ? 2 : 3; }
constexpr int KO = 2;               // float4 outputs a thread merges at once

// 16 bytes from global to shared memory; zeros where !live
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   gqa::saddr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// Dynamic shared memory: the query rows [16 MT][D + PAD] bf16, then NSTAGE
// stages of a K tile and a V tile [TR][D + PAD] bf16; the merge reuses it.
// NT: n8 output tiles a warp owns (D / 32, rounded up to 2, 4 or 8).
template <int MT, int NT>
__global__ void __launch_bounds__(THREADS) decode_attn_mma(const Args a) {
  constexpr int NSTAGE = nstage(NT);
  constexpr int PS = TR + gqa::PAD;           // bf16 a P row
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  // a warp's row maxima of a tile (its row sums at the end); the tile's p
  // as bf16 hi and lo parts [16 MT][TR + PAD]
  __shared__ float wmax[WARPS][16 * MT];
  __shared__ __align__(16) __nv_bfloat16 ph[16 * MT * PS], pl[16 * MT * PS];
  const float NEG_INF = -INFINITY;
  const int D = a.d, KS = D + gqa::PAD, nt_d = D / 32;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + 16 * MT * KS;

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / (a.hkv * a.chunks), h = bh / a.chunks % a.hkv;
  const int c = bh % a.chunks;
  const int G = min(a.gc, a.g - c * a.gc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = lane & 3, gq = lane >> 2;
  const int hq = a.hkv * a.g;
  const size_t head0 =
      (size_t)b * hq + (size_t)h * a.g + (size_t)c * a.gc;

  // the query rows' loads in flight beside past_len's and the first tiles'
  gqa::QRows<16 * MT> qr;
  gqa::q_load(qr, a.q + head0 * D, G, D, tid);
  const int past_len =
      min(max(__ldg(a.past_len + b * a.past_len_stride), 0), a.limit - 1);
  const int hi = min(a.limit, past_len + 1);
  const int lo = a.window > 0 ? max(0, past_len - a.window + 1) : 0;
  const int r_lo = max(lo, split * a.per);
  const int r_hi = min(hi, (split + 1) * a.per);

  if (r_lo < r_hi) {
    const size_t base = (size_t)a.layer * a.sl + (size_t)b * a.sb +
                        (size_t)h * a.sh;
    const __nv_bfloat16* kp = a.k + base;
    const __nv_bfloat16* vp = a.v + base;
    const int tiles = (r_hi - r_lo + TR - 1) / TR;
    // thread tid copies 16-byte piece tid % pieces of rows tid / pieces,
    // + rpp, ... of a tile (threads past rpp * pieces copy nothing)
    const int pieces = D / 8, rpp = THREADS / pieces;
    const int j0 = tid < rpp * pieces ? tid / pieces : TR;
    const int e0 = (tid % pieces) * 8;
    // the K and V rows of tile i into stage s, rows from r_hi on zero
    const auto issue = [&](int i, int s) {
      __nv_bfloat16* kt = ring + (size_t)s * 2 * TR * KS + e0;
      __nv_bfloat16* vt = kt + TR * KS;
      const int r0 = r_lo + i * TR;
      for (int j = j0; j < TR; j += rpp) {
        const bool live = r0 + j < r_hi;
        const size_t off = (size_t)(live ? r0 + j : r_lo) * a.ss + e0;
        cp16(kt + j * KS, kp + off, live);
        cp16(vt + j * KS, vp + off, live);
      }
    };
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < tiles) issue(s, s);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    gqa::q_store(qr, qs, KS, D, tid);

    // lane (gq, tq) holds rows (query heads) 16 mt + gq + 8 half of every
    // m-tile; its O columns are col0 + 8 nt + 2 tq (+1)
    const int col0 = warp * (D / 4);
    float o_acc[MT][NT][4], m[MT][2], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m[mt][hf] = NEG_INF;
        l[mt][hf] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o_acc[mt][nt][e] = 0.f;
    }

    for (int i = 0; i < tiles; ++i) {
      // tile i has landed and every warp is done with tile i - 1, whose
      // stage takes tile i + NSTAGE - 1
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2) : "memory");
      __syncthreads();
      if (i + NSTAGE - 1 < tiles)
        issue(i + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const __nv_bfloat16* kt = ring + (size_t)(i % NSTAGE) * 2 * TR * KS;
      const __nv_bfloat16* vt = kt + TR * KS;
      const int t0 = r_lo + i * TR;

      // S = Q.K^T of the tile's rows 8 warp .. 8 warp + 7 (one n8 tile a
      // warp), every m-tile against the same K fragment
      float s[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t bk[2];
        gqa::b_frag(bk, kt, KS, 8 * warp, k0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t aq[4];
          gqa::a_frag(aq, qs, KS, 16 * mt, k0, lane);
          gqa::mma(s[mt], aq, bk);
        }
      }
      // scale, softcap, mask; each row's max over the warp's 8 columns (2
      // a lane, the quad's 4 lanes) to shared memory
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = NEG_INF;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[mt][2 * hf + e] * a.scale;
            if (a.softcap > 0.f) x = tanhf(x * a.inv_softcap) * a.softcap;
            x = t0 + 8 * warp + 2 * tq + e < r_hi ? x : NEG_INF;
            s[mt][2 * hf + e] = x;
            mx = fmaxf(mx, x);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if (tq == 0) wmax[warp][16 * mt + gq + 8 * hf] = mx;
        }
      }
      __syncthreads();
      // the tile's max of each row over the four warps, in warp order (the
      // same m in every warp); p = exp(s - m) as hi + lo bf16 parts into
      // the P tiles, the lane's share of the row sums, O rescaled
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * mt + gq + 8 * hf;
          float mx = wmax[0][row];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, wmax[w][row]);
          // finite: the first tile holds row r_lo; exp(-inf) = 0 at first
          const float m_new = fmaxf(m[mt][hf], mx);
          const float al = expf(m[mt][hf] - m_new);
          const float p0 = expf(s[mt][2 * hf] - m_new);
          const float p1 = expf(s[mt][2 * hf + 1] - m_new);
          l[mt][hf] = l[mt][hf] * al + (p0 + p1);
          m[mt][hf] = m_new;
          const uint32_t h = gqa::pack(p0, p1);
          const int o = row * PS + 8 * warp + 2 * tq;
          *reinterpret_cast<uint32_t*>(ph + o) = h;
          *reinterpret_cast<uint32_t*>(pl + o) = gqa::residue(p0, p1, h);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            o_acc[mt][nt][2 * hf] *= al;
            o_acc[mt][nt][2 * hf + 1] *= al;
          }
        }
      }
      __syncthreads();

      // O += P.V over the tile's two k16 steps: A fragments of the P tiles
      // (hi and lo), V by ldmatrix.trans; warp w its D / 4 columns
#pragma unroll
      for (int kk = 0; kk < TR / 16; ++kk) {
        uint32_t ah[MT][4], alo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          gqa::a_frag(ah[mt], ph, PS, 16 * mt, 16 * kk, lane);
          gqa::a_frag(alo[mt], pl, PS, 16 * mt, 16 * kk, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_d) {
            uint32_t bv[2];
            gqa::b_frag_t(bv, vt, KS, 16 * kk, col0 + 8 * nt, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              gqa::mma(o_acc[mt][nt], ah[mt], bv);
              gqa::mma(o_acc[mt][nt], alo[mt], bv);
            }
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");

    // the row sums over the quad, then over the warps in order (every warp
    // holds the same m)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x = l[mt][hf];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (tq == 0) wmax[warp][16 * mt + gq + 8 * hf] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * mt + gq + 8 * hf;
        float x = wmax[0][row];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) x += wmax[w][row];
        l[mt][hf] = x;
      }
    }
    const size_t sp = (size_t)split * a.batch * hq + head0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * mt + gq + 8 * hf;
        if (row >= G) continue;
        float* dst = a.splits == 1 ? a.out + (head0 + row) * D
                                   : a.pacc + (sp + row) * D;
        const float inv = a.splits == 1 ? 1.f / l[mt][hf] : 1.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_d)
            *reinterpret_cast<float2*>(dst + col0 + 8 * nt + 2 * tq) =
                make_float2(o_acc[mt][nt][2 * hf] * inv,
                            o_acc[mt][nt][2 * hf + 1] * inv);
        }
        if (a.splits > 1 && warp == 0 && tq == 0) {
          a.pml[(sp + row) * 2] = m[mt][hf];
          a.pml[(sp + row) * 2 + 1] = l[mt][hf];
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

  // the last block of this (batch, KV head, head block) merges the splits
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(&a.count[bh], 1) == a.splits - 1;
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // (m, l) of every split, then each split's weight e^(m_s - M) in place of
  // its m and L = sum l_s e^(m_s - M); the sums run in split order. An
  // empty split's acc was never written: its weight is 0 and its value is
  // never loaded.
  const size_t stride = (size_t)a.batch * hq;
  float* ce = reinterpret_cast<float*>(smem);      // [splits][G]
  float* cl = ce + a.splits * G;                   // [splits][G]
  float* cL = cl + a.splits * G;                   // [G]
  for (int i = tid; i < a.splits * G; i += THREADS) {
    const int s = i / G, g = i - s * G;
    const float* ml = &a.pml[((size_t)s * stride + head0 + g) * 2];
    ce[i] = __ldcg(ml);
    cl[i] = __ldcg(ml + 1);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float mm = NEG_INF;
    for (int s = 0; s < a.splits; ++s) mm = fmaxf(mm, ce[s * G + g]);
    float L = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = ce[s * G + g];
      const float e = ms == NEG_INF ? 0.f : expf(ms - mm);
      ce[s * G + g] = e;
      L += cl[s * G + g] * e;
    }
    cL[g] = L;
  }
  __syncthreads();
  // KO float4 outputs a thread, eight splits' loads in flight a round
  const int GD4 = G * D / 4;
  const float4* pacc4 = reinterpret_cast<const float4*>(a.pacc);
  for (int o0 = tid; o0 < GD4; o0 += KO * THREADS) {
    float4 x[KO];
#pragma unroll
    for (int k = 0; k < KO; ++k) x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < a.splits; s0 += 8) {
      float4 pv[KO][8];
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        const int o = o0 + k * THREADS, g = min(4 * o / D, G - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pv[k][j] =
              o < GD4 && s0 + j < a.splits && ce[(s0 + j) * G + g] != 0.f
                  ? __ldcg(&pacc4[((size_t)(s0 + j) * stride + head0) * D / 4 +
                                  o])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        const int g = min(4 * (o0 + k * THREADS) / D, G - 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e = s0 + j < a.splits ? ce[(s0 + j) * G + g] : 0.f;
          if (e != 0.f) {
            x[k].x += pv[k][j].x * e;
            x[k].y += pv[k][j].y * e;
            x[k].z += pv[k][j].z * e;
            x[k].w += pv[k][j].w * e;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k * THREADS;
      if (o < GD4) {
        const float inv = 1.f / cL[4 * o / D];
        reinterpret_cast<float4*>(a.out)[head0 * D / 4 + o] =
            make_float4(x[k].x * inv, x[k].y * inv, x[k].z * inv,
                        x[k].w * inv);
      }
    }
  }
  if (tid == 0) a.count[bh] = 0;
}

// the bytes of the mma template's dynamic shared memory
int mma_smem(int mt, int d, int gc, int splits) {
  const int ks = d + gqa::PAD;
  const int tiles = (16 * mt * ks + nstage(d > 128 ? 8 : 4) * 2 * TR * ks) * 2;
  const int merge = (2 * splits * gc + gc) * 4;
  return tiles > merge ? tiles : merge;
}

template <int MT, int NT>
cudaError_t launch_mma(const Args& a, dim3 grid, int smem, cudaStream_t st) {
  static int opted = 0;                       // opt in to what a launch needs
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_mma<MT, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  decode_attn_mma<MT, NT><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mt(const Args& a, int mt, dim3 grid, int smem,
                      cudaStream_t st) {
  if (mt == 1) return launch_mma<1, NT>(a, grid, smem, st);
  if (mt == 2) return launch_mma<2, NT>(a, grid, smem, st);
  if (mt == 3) return launch_mma<3, NT>(a, grid, smem, st);
  return launch_mma<4, NT>(a, grid, smem, st);
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
// clamps it into that range). mt: 0 for the CUDA-core template (gc = g =
// 1), else the m16 tiles of the mma template (16 (mt - 1) < gc <= 16 mt,
// mt <= 4).
// Requires D % 32 == 0, D <= 256, splits <= 64, 16-byte aligned K/V rows
// (ss and the bases multiples of 8 elements).
// Returns the cudaError_t of the launch (0 on success).
int decode_attention(const void* q, const void* k, const void* v,
                     long long sl, long long sb, long long sh, long long ss,
                     int layer, int batch, int hkv, int g, int gc, int mt,
                     int d, const void* past_len, int past_len_stride,
                     int limit,
                     float scale, float softcap,
                     int window, int splits, int per, void* out, void* pacc,
                     void* pml, void* count, void* stream) {
  if (d % 32 || d > 256 || g < 1 || gc < 1 || gc > g || mt < 0 ||
      mt > gqa::MAX_MT ||
      (mt == 0 && gc != MAX_G) ||
      (mt > 0 && (gc > 16 * mt || gc <= 16 * (mt - 1))) ||
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
  if (mt > 0) {
    const int smem = mma_smem(mt, d, gc, splits);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (d <= 64) return (int)launch_mt<2>(a, mt, grid, smem, st);
    if (d <= 128) return (int)launch_mt<4>(a, mt, grid, smem, st);
    return (int)launch_mt<8>(a, mt, grid, smem, st);
  }
  if (d <= 32) return (int)launch_core<4>(a, grid, st);
  if (d <= 64) return (int)launch_core<8>(a, grid, st);
  if (d <= 128) return (int)launch_core<16>(a, grid, st);
  return (int)launch_core<32>(a, grid, st);
}

}  // extern "C"
