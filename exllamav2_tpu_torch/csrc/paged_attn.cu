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
//   M_j    = max of the scores of pages 0 .. j (the reference's running max)
//   p      = exp(s - M_j) for a row of page j; l = sum_j exp(M_j - M_last)
//            * sum p;  acc = sum_j exp(M_j - M_last) * (bf16(p) . v)
//   out    = acc / (l == 0 ? 1 : l)                       (f32 [B, Hq, D])
// p rounds to bf16 against the running max of the pages so far, as in the
// Pallas kernel (paged_attn.py:151-184): kernel and plain version
// (ops/paged_attn.py) differ in f32 summation order only. The inverse
// Hadamard of the q4/q8 kinds stays outside (the caller pre-rotates q and
// post-rotates the output).
//
// Bound on the H100: memory. Every live K and V row is read once (bf16, D
// 128: 512 B per row and head; q4: 128 B + 8 B of scales) for 4*G flops per
// element, so the least time is those bytes over 3.35 TB/s (serving, 16
// sequences of 152 rows, 32 KV heads: 39.9 MB per layer, 11.9 us). The
// bytes do not grow with G, the work does (48 query heads on one KV head
// read 1/48 of the bytes of 48 KV heads).
//
// Design (both templates):
//   * split over the sequence: the grid is (batch * Hkv * head blocks,
//     splits) and split r takes positions [r*per, (r+1)*per), per a
//     multiple of 16 rows that may cross page boundaries
//     (ops/paged_attn.split_count picks splits and per from the block
//     table's width and the SM count, never from valid_lens, so a page
//     bucket has one grid). A split's live rows are those inside
//     [n - window, n). A split with none exits at once, so it holds no SM
//     slot while its cluster works (a cluster barrier waits for the threads
//     that have not exited); the live splits are contiguous ranks, which
//     every block computes from valid_lens, and only they are read by the
//     exchange and the merge. Copies take whole 16-row groups; masking goes
//     by position, never by page index (page 0 is the null page of pad
//     rows), and rows outside the live range are never read.
//   * the splits of one (sequence, KV head, head block) form a thread-block
//     cluster. Each block scores its rows into shared memory and publishes
//     T (the max of its scores) and F (the max of its rows in its first
//     page) per query head. After a cluster barrier every block reads those
//     of the others through distributed shared memory: M_j of its page j is
//     the max of E (the T of every earlier split), its own scores of pages
//     up to j, and, for its last page, the F of later splits that start in
//     that page. p and its weight exp(M_j - M_last) follow. The live
//     splits' acc and l are summed in rank order through distributed shared
//     memory (as csrc/qmm.cu merges its K splits): one launch,
//     deterministic, no float atomics, no global scratch, so a CUDA graph
//     can replay it with new valid_lens.
//   * copies: a three-stage ring of row chunks in shared memory (K rows in
//     the scoring pass, V rows and their scales in the P.V pass, ~8 KB a
//     chunk: 32 bf16 rows at D = 128; 16 KB where a split holds 48 KB of
//     rows or more), two chunks in flight while one is scored or
//     accumulated. One thread starts a chunk with one
//     tensor-memory-accelerator bulk copy for each page it touches (a
//     page's rows are contiguous in the pool), completing on the stage's
//     mbarrier; per-thread 16-byte cp.async copies of the same chunks
//     streamed at about half the rate (PERF.md), and one bulk copy a row
//     into padded rows was slower again (PERF.md). The split's
//     block-table entries are staged in shared memory first, so a copy's
//     address waits on no load.
//   * the cluster's values (T, F, then l) are read one a lane and the
//     merge issues every rank's read before it sums, so a distributed
//     shared memory round trip is paid once, not once a rank.
//   * scores of up to SC_FLOATS / G rows (SC_MMA / G on the mma template)
//     are kept; a split with more live rows keeps the max pass but scores
//     its rows again, window by window, in the P.V pass (K read twice).
//     Windows hold whole pages, so a page's max is known in one.
//
// The CUDA-core template (G < ops/paged_attn.MMA_MIN_G; one query head a
// KV head on the models served, and the G = 2 .. 4 where it measured
// faster, PERF.md):
//   * scores: THREADS / chunk rows lanes per K row (4 for bf16 at D = 128),
//     16-byte pieces of the row dequantized in registers and dotted with q
//     for all G heads, summed across the row's lanes by shuffles; the lanes
//     of a load phase take their pieces in an order that puts them on
//     distinct bank groups.
//   * P.V: a lane owns 4 consecutive elements of the head (one 8-byte load
//     a bf16 row) for every query head of a row group; the row groups are
//     summed in order at the end. Weights bf16(p) * exp(M_j - M_last).
//   * a block holds all G heads of its KV head (G <= 4: the entry refuses
//     more); gc is a template bucket (1 or 4) so the per-head loops unroll
//     to what the model needs.
//
// The mma template (G >= MMA_MIN_G): a KV head's query heads are one
// tensor-core tile, its K/V rows read once for all of them.
//   * a block holds all G heads of a KV head as ceil(G / 16) m16 tiles (MT,
//     a template parameter; rows past G zero and never written), up to
//     gqa::MAX_MT = 4 (64 heads; more go to ceil(G / 64) blocks): the query
//     rows staged once as bf16 rows of stride D + 8;
//   * each staged chunk is dequantized by all threads into bf16 rows of
//     stride D + 8 (kvb; the reference's rounding point, paged_attn.py:
//     154-157), whose padding puts the eight rows an ldmatrix phase reads on
//     distinct bank groups (the bulk copies cannot pad); but a q4 K chunk,
//     whose B fragments each lane dequantizes from the staged nibbles
//     (score_tiles_q4: two 16-bit words of its row give the fragments of
//     two k16 steps, the low and the high nibbles), so its scores need no
//     bf16 rows and no barrier after the copy's;
//   * scores: S = Q.K^T by mma.sync.m16n8k16 (bf16 in, f32 out), warp w
//     takes the n8 row tiles w, w + 4, ... of the chunk, every m-tile
//     against the same B fragment (ldmatrix, or the nibbles); scale,
//     softcap and the position mask on the accumulator, then into the
//     scores of the window;
//   * P.V: weights bf16(exp(s - M_j)) (the reference's p.astype(bf16)), the
//     A fragments read from the scores' f32 rows (exact in bf16), V by
//     ldmatrix.trans from kvb; warp w owns output columns [w*D/4,
//     (w+1)*D/4) for all heads (MT x D/8 f32 a lane). Pages are multiples
//     of 16 rows, so a k16 step never straddles a page: the accumulator is
//     rescaled by exp(M_j - M_j') (<= 1) where a 16-row group's page max
//     changes, and by exp(M_jl - M_last) at the end, which equals the
//     CUDA-core template's weights up to f32 rounding;
//   * each warp writes its columns to the merge buffer: no row-group sums.
//   Registers and shared memory of each instantiation: PERF.md (nvcc
//   -Xptxas -v in chip_smoke.py's build phase). The template loses to the
//   CUDA-core one at G = 2 (D = 256) and at G = 4 for q4 and for bf16 at
//   16 sequences (the conversion pass and a second barrier a chunk cost
//   more than four heads' shuffles), hence MMA_MIN_G = 5. The pass cost
//   most for q4 (16 % slower than the 16-head chunks it replaced at 48/1
//   heads, batch 1), whose K scoring now skips it: 47.7 -> 42.5 us there
//   (PERF.md); V still takes the bf16 rows (a lane's B fragment of P.V
//   spans four rows, each a byte load and a scale).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include "gqa_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NST = 3;               // stages of the copy ring
constexpr int MAX_SPLITS = 16;       // blocks of a cluster (non-portable)
constexpr int MAX_G = 4;             // query heads a block of the
                                     // CUDA-core template (G < MMA_MIN_G)
constexpr int CHUNK_BYTES = 8192;    // rows of a chunk: about this many bytes
constexpr int CHUNK_LONG = 16384;    // ... where a split holds three of these
constexpr int BT_MAX = 64;           // block-table entries staged per split
constexpr int SC_FLOATS = 8192;      // scores a block keeps (G x rows)
constexpr int MAX_SMEM = 100 * 1024;
constexpr int MAX_SMEM_MMA = 227 * 1024;
constexpr float NEG = -1e30f;

enum Kind { BF16 = 0, FP8 = 1, Q8 = 2, Q4 = 3 };

__host__ __device__ constexpr int row_bytes(int k, int d) {
  return k == BF16 ? 2 * d : (k == Q4 ? d / 2 : d);
}

struct Args {
  const __nv_bfloat16* q;           // [B, Hq, D]
  const uint8_t* k;                 // pool bases [L, Hkv, rows, D']
  const uint8_t* v;
  const uint8_t* ks;                // [L, Hkv, rows, D/32] bf16 or null
  const uint8_t* vs;
  const int* bt;                    // [B, pw]
  const int* vl;                    // [B]
  int layer, hkv, g, d, rows, ps, pw, window;
  int gc, chunks;                   // heads of a chunk; chunks a KV head
  float scale, softcap, inv_softcap;
  float* out;                       // [B, Hq, D]
  int per;                          // positions of a split (multiple of 16)
  int cr, tpr;                      // rows of a chunk; lanes per K row
  int swz;                          // K pieces a row is a power of two
  int wr;                           // score rows of a window
  int stage_bytes, off_scl;         // one ring stage; its scales' offset
  int off_ring, off_sc;             // dynamic smem: q at 0, ring, scores
  int kk, vk, mt;                   // the kinds; m16 tiles (0: CUDA-core)
  int off_kvb, off_mg;              // mma template: bf16 rows; groups' M_j
};

// what a block knows of its split
struct Blk {
  int b, h, rank;
  int g;                            // query heads of this block's chunk
  int r_lo, r_hi;                   // the cluster's live ranks [r_lo, r_hi)
  int a0, a1;                       // live positions [a0, a1)
  int a0a, a1a;                     // aligned out to 16
  int j0, jl;                       // pages of the split's first and last row
  bool live, keep;                  // keep: one window holds every score
  bool tab;                         // the split's pages are staged in bts
  size_t head;                      // layer * hkv + h
};

// the chunk the ring fetches next: pass 0 scores, pass 1 weights and P.V
// (K again first where the scores were not kept), pass 2 nothing left
struct Cur {
  int pass, ws, we, c0;
  bool isv;
};

__device__ __forceinline__ int win_end(const Args& a, const Blk& k, int ws) {
  return k.a1a - ws <= a.wr ? k.a1a : (ws + a.wr) / a.ps * a.ps;
}

__device__ __forceinline__ void advance(const Args& a, const Blk& k,
                                        Cur& c) {
  c.c0 += a.cr;
  if (c.c0 < c.we) return;
  if (c.pass == 0) {
    if (c.we < k.a1a) {
      c.ws = c.we;
    } else {
      c.pass = 1;
      c.ws = k.a0a;
      c.isv = k.keep;
    }
  } else if (c.pass == 1) {
    if (!c.isv) {
      c.isv = true;
      c.c0 = c.ws;
      return;
    }
    if (c.we >= k.a1a) {
      c.pass = 2;
      return;
    }
    c.ws = c.we;
    c.isv = false;
  } else {
    return;
  }
  c.we = win_end(a, k, c.ws);
  c.c0 = c.ws;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a tensor-memory-accelerator copy of `bytes` (a multiple of 16) from device
// memory to shared memory, counted on the stage's mbarrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the pool row of position pos: the block-table entry from shared memory
// (bts holds pages j0 .. jl of the split) or, for a long split, from device
// memory
__device__ __forceinline__ size_t phys_row(const Args& a, const Blk& k,
                                           const int* bts, int pos) {
  const int page = pos / a.ps;
  const int e = k.tab ? bts[page - k.j0] : a.bt[(size_t)k.b * a.pw + page];
  return (size_t)e * a.ps + (pos - page * a.ps);
}

// Thread 0 starts the copies of chunk `c` (K or V rows and their scales)
// into stage `st`: one bulk copy for each page the chunk touches (a page's
// rows are contiguous in the pool), all counted on the stage's mbarrier.
// The chunk's 16-row groups are copied whole; rows outside the live range
// are never read.
__device__ __forceinline__ void issue(const Args& a, const Blk& k,
                                      const int* bts, const Cur& c,
                                      uint8_t* st, uint64_t* bar, int kk,
                                      int vk) {
  if (c.pass == 2 || threadIdx.x != 0) return;
  const int kind = c.isv ? vk : kk;
  const uint32_t rb = row_bytes(kind, a.d);
  const uint32_t sb = kind >= Q8 ? a.d / 16 : 0;    // scale bytes a row
  const uint8_t* base = (c.isv ? a.v : a.k) + k.head * a.rows * rb;
  const uint8_t* sbase = (c.isv ? a.vs : a.ks) + k.head * a.rows * sb;
  const int c1 = min(c.c0 + a.cr, c.we);
  mbar_expect(bar, (uint32_t)(c1 - c.c0) * (rb + sb));
  for (int p0 = c.c0, pe; p0 < c1; p0 = pe) {
    const int page = p0 / a.ps;
    pe = min(c1, (page + 1) * a.ps);
    const size_t row = phys_row(a, k, bts, p0);
    const uint32_t n = pe - p0;
    bulk_copy(st + (p0 - c.c0) * rb, base + row * rb, n * rb, bar);
    if (sb)
      bulk_copy(st + a.off_scl + (p0 - c.c0) * sb, sbase + row * sb, n * sb,
                bar);
  }
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

// part[g] += q[g] . k over the 16-byte piece `c` of a staged K row
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

// Elements d0 .. d0 + 3 of a staged V row, dequantized and rounded to bf16.
template <int KIND>
__device__ __forceinline__ void v_elems(const uint8_t* row,
                                        const __nv_bfloat16* srow, int d0,
                                        int d, float (&x)[4]) {
  if constexpr (KIND == BF16) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + 2 * d0);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  } else if constexpr (KIND == FP8) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d0);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = fp8_val((w >> (8 * e)) & 255u);
  } else if constexpr (KIND == Q8) {
    const float s = __bfloat162float(srow[d0 >> 5]);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d0);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = rbf((float)((int)((w >> (8 * e)) & 255u) - 128) * s);
  } else {
    const float s = __bfloat162float(srow[d0 >> 5]);
    const int half = d / 2;
    const bool lo = d0 < half;
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(row + (lo ? d0 : d0 - half));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t b = (w >> (8 * e)) & 255u;
      x[e] = rbf((float)((int)(lo ? (b & 15u) : (b >> 4)) - 8) * s);
    }
  }
}

// Scores of the chunk rows [c0, c1) into sc[g][pos - ws]; NEG outside the
// live range.
template <int KK, int GB>
__device__ __forceinline__ void score_chunk(const Args& a, const Blk& k,
                                            int c0, int c1, int ws,
                                            const uint8_t* st,
                                            const float* qs, float* sc) {
  const int i = threadIdx.x / a.tpr, part = threadIdx.x % a.tpr;
  const int pos = c0 + i;
  const int kch = row_bytes(KK, a.d) / 16;
  float ps[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) ps[g] = 0.f;
  if (pos < c1) {
    const uint4* kr =
        reinterpret_cast<const uint4*>(st + i * row_bytes(KK, a.d));
    const __nv_bfloat16* sr =
        reinterpret_cast<const __nv_bfloat16*>(st + a.off_scl) +
        i * (a.d / 32);
    // the lanes of a 16-byte load phase (8 / tpr rows, tpr pieces each)
    // take pieces on distinct bank groups: piece j*tpr + part XOR x(i)
    int x = 0;
    if (a.swz)
      x = kch >= 8 ? a.tpr * (i % (8 / a.tpr))
                   : a.tpr * ((i / (8 / kch)) % (kch / a.tpr));
    for (int c = part; c < kch; c += a.tpr)
      dot_chunk<KK, GB>(kr[c ^ x], c ^ x, a.d, k.g, qs, sr, ps);
  }
  for (int o = a.tpr >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      ps[g] += __shfl_xor_sync(0xffffffffu, ps[g], o);
  }
  if (part == 0 && pos < c1) {
    const bool ok = pos >= k.a0 && pos < k.a1;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < k.g) {
        float s = ps[g] * a.scale;
        if (a.softcap > 0.f) s = tanhf(s * a.inv_softcap) * a.softcap;
        sc[g * a.wr + pos - ws] = ok ? s : NEG;
      }
    }
  }
}

// acc += weight . v over the live rows of the V chunk [c0, c1)
template <int VK, int GB>
__device__ __forceinline__ void pv_chunk(const Args& a, const Blk& k, int c0,
                                         int c1, int ws, const uint8_t* st,
                                         const float* sc,
                                         float (&acc)[GB][4]) {
  const int w4 = a.d / 4;                 // lanes of a row group
  const int rg = threadIdx.x / w4, d0 = 4 * (threadIdx.x % w4);
  const int ngr = THREADS / w4;
  if (rg >= ngr) return;
  const int vb = row_bytes(VK, a.d);
  const __nv_bfloat16* sbuf =
      reinterpret_cast<const __nv_bfloat16*>(st + a.off_scl);
  const int r_hi = min(c1, k.a1);
#pragma unroll 2
  for (int pos = max(c0, k.a0) + rg; pos < r_hi; pos += ngr) {
    const int i = pos - c0;
    float x[4];
    v_elems<VK>(st + i * vb, sbuf + i * (a.d / 32), d0, a.d, x);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < k.g) {
        const float w = sc[g * a.wr + pos - ws];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(w, x[e], acc[g][e]);
      }
    }
  }
}

// blocks per SM the register budget is cut for (at G = 1 shared memory lets
// eight share an SM)
__host__ __device__ constexpr int min_blocks(int gb) {
  return gb == 1 ? 8 : 4;
}

template <int KK, int VK, int GB>
__global__ void __launch_bounds__(THREADS, min_blocks(GB))
    paged_attn_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  // per query head: published T, F (read by the cluster), this block's l
  // (read by the merge), the running max of the weights pass, and E, X,
  // M_last from the exchange; the values read from the cluster [G][splits]
  __shared__ float t_sh[MAX_G], f_sh[MAX_G], l_sh[MAX_G], run_sh[MAX_G];
  __shared__ float e_sh[MAX_G], x_sh[MAX_G], ml_sh[MAX_G];
  __shared__ float xt[MAX_G * MAX_SPLITS], xf[MAX_G * MAX_SPLITS];
  __shared__ int bts[BT_MAX];
  __shared__ __align__(8) uint64_t bars[NST];   // one mbarrier a stage
  float* qs = reinterpret_cast<float*>(smem);
  uint8_t* ring = smem + a.off_ring;
  float* sc = reinterpret_cast<float*>(smem + a.off_sc);
  cg::cluster_group cluster = cg::this_cluster();

  Blk k;
  k.b = blockIdx.x / (a.hkv * a.chunks);
  k.h = blockIdx.x / a.chunks % a.hkv;
  const int chunk = blockIdx.x % a.chunks;
  k.g = min(a.gc, a.g - chunk * a.gc);
  const int G = k.g, D = a.d, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  k.rank = (int)cluster.block_rank();
  k.head = (size_t)a.layer * a.hkv + k.h;
  const int hq = a.hkv * a.g;
  const size_t qoff =
      ((size_t)k.b * hq + (size_t)k.h * a.g + (size_t)chunk * a.gc) * D;
  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = __bfloat162float(a.q[qoff + i]);
  if (tid < G) {
    t_sh[tid] = NEG;
    f_sh[tid] = NEG;
    l_sh[tid] = 0.f;
    run_sh[tid] = NEG;
  }
  const int n = a.vl[k.b];
  const int lo_abs = a.window > 0 ? max(n - a.window, 0) : 0;
  const int s0 = k.rank * a.per, s1 = min(s0 + a.per, a.pw * a.ps);
  k.a0 = max(s0, lo_abs);
  k.a1 = min(s1, n);
  k.live = k.a0 < k.a1;
  k.a0a = k.a0 & ~15;
  k.a1a = (k.a1 + 15) & ~15;
  k.keep = k.a1a - k.a0a <= a.wr;
  k.j0 = s0 / a.ps;
  k.jl = (s1 - 1) / a.ps;
  // the splits with live rows are contiguous; every block of the cluster
  // computes the same range from valid_lens
  const int n_end = min(n, a.pw * a.ps);
  k.r_lo = lo_abs / a.per;
  k.r_hi = lo_abs < n_end ? (n_end - 1) / a.per + 1 : k.r_lo;
  k.tab = k.jl - k.j0 < BT_MAX;
  if (k.tab) {
    for (int i = tid; i <= k.jl - k.j0; i += THREADS)
      bts[i] = a.bt[(size_t)k.b * a.pw + k.j0 + i];
  }
  if (!k.live) {
    // an empty split leaves at once: no block reads it (the exchange and
    // the merge take the live ranks only) and a cluster barrier waits for
    // the threads that have not exited. With no live row anywhere, rank 0
    // writes the zero output.
    if (k.r_lo >= k.r_hi && k.rank == 0) {
      for (int o = tid; o < G * D; o += THREADS) a.out[qoff + o] = 0.f;
    }
    return;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

  // the ring: chunk ci sits in stage ci % NST, its mbarrier's phase is
  // (ci / NST) & 1; consume() waits for chunk ci and, once every thread is
  // done with chunk ci - 1, starts the copy of chunk ci + NST - 1 into its
  // stage
  Cur nx = {0, k.a0a, 0, k.a0a, false};
  nx.we = win_end(a, k, k.a0a);
  int ci = 0;
  auto consume = [&]() -> const uint8_t* {
    const int s = ci % NST;
    mbar_wait(&bars[s], (ci / NST) & 1);
    __syncthreads();
    const int s2 = (ci + NST - 1) % NST;
    issue(a, k, bts, nx, ring + s2 * a.stage_bytes, &bars[s2], KK, VK);
    advance(a, k, nx);
    ++ci;
    return ring + s * a.stage_bytes;
  };
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    issue(a, k, bts, nx, ring + s * a.stage_bytes, &bars[s], KK, VK);
    advance(a, k, nx);
  }
  // ---- pass 0: scores, and per head T (all rows) and F (first page)
  for (int ws = k.a0a, we; ws < k.a1a; ws = we) {
    we = win_end(a, k, ws);
    for (int c0 = ws; c0 < we; c0 += a.cr) {
      const uint8_t* st = consume();
      score_chunk<KK, GB>(a, k, c0, min(c0 + a.cr, we), ws, st, qs, sc);
    }
    __syncthreads();
    for (int g = warp; g < G; g += WARPS) {
      for (int p0 = ws, pe; p0 < we; p0 = pe) {
        const int page = p0 / a.ps;
        pe = min(we, (page + 1) * a.ps);
        float mx = NEG;
        for (int r = p0 + lane; r < pe; r += 32)
          mx = fmaxf(mx, sc[g * a.wr + r - ws]);
        mx = warp_max(mx);
        if (lane == 0) {
          t_sh[g] = fmaxf(t_sh[g], mx);
          if (page == k.j0) f_sh[g] = fmaxf(f_sh[g], mx);
        }
      }
    }
  }

  // ---- exchange over the live ranks: E (earlier splits), X (later splits
  // starting in this split's last page) and M_last of every head
  const int nl = k.r_hi - k.r_lo;
  cluster.sync();
  for (int i = tid; i < G * nl; i += THREADS) {         // one read a lane
    const int g = i / nl, r = k.r_lo + i - g * nl;
    xt[i] = *cluster.map_shared_rank(&t_sh[g], r);
    xf[i] = *cluster.map_shared_rank(&f_sh[g], r);
  }
  __syncthreads();
  if (tid < G) {
    float e = NEG, x = NEG, ml = NEG;
    for (int j = 0; j < nl; ++j) {
      const int r = k.r_lo + j;
      const float t = xt[tid * nl + j];
      ml = fmaxf(ml, t);
      if (r < k.rank) e = fmaxf(e, t);
      if (r > k.rank && r * a.per / a.ps == k.jl)
        x = fmaxf(x, xf[tid * nl + j]);
    }
    e_sh[tid] = e;
    x_sh[tid] = x;
    ml_sh[tid] = ml;
  }
  __syncthreads();

  // ---- pass 1: weights bf16(exp(s - M_j)) * exp(M_j - M_last), l, P.V
  for (int ws = k.a0a, we; ws < k.a1a; ws = we) {
    we = win_end(a, k, ws);
    if (!k.keep) {
      for (int c0 = ws; c0 < we; c0 += a.cr) {
        const uint8_t* st = consume();
        score_chunk<KK, GB>(a, k, c0, min(c0 + a.cr, we), ws, st, qs, sc);
      }
      __syncthreads();
    }
    for (int g = warp; g < G; g += WARPS) {
      const float e = e_sh[g], x = x_sh[g], ml = ml_sh[g];
      float run = run_sh[g], lsum = 0.f;
      for (int p0 = ws, pe; p0 < we; p0 = pe) {
        const int page = p0 / a.ps;
        pe = min(we, (page + 1) * a.ps);
        float mx = NEG;
        for (int r = p0 + lane; r < pe; r += 32)
          mx = fmaxf(mx, sc[g * a.wr + r - ws]);
        run = fmaxf(run, warp_max(mx));
        float mj = fmaxf(e, run);
        if (page == k.jl) mj = fmaxf(mj, x);
        const float fac = expf(mj - ml);
        for (int r = p0 + lane; r < pe; r += 32) {
          float* sp = sc + g * a.wr + r - ws;
          const bool ok = r >= k.a0 && r < k.a1;
          const float p = ok ? expf(*sp - mj) : 0.f;
          lsum += p * fac;
          *sp = rbf(p) * fac;
        }
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        l_sh[g] += lsum;
        run_sh[g] = run;
      }
    }
    for (int c0 = ws; c0 < we; c0 += a.cr) {
      const uint8_t* st = consume();
      pv_chunk<VK, GB>(a, k, c0, min(c0 + a.cr, we), ws, st, sc, acc);
    }
  }
  __syncthreads();

  // ---- the row groups summed in order into buf [G][D] (the ring)
  float* buf = reinterpret_cast<float*>(ring);
  {
    const int w4 = D / 4, ngr = THREADS / w4;
    const int rg = tid / w4, d0 = 4 * (tid % w4);
    for (int r = 0; r < ngr; ++r) {
      if (rg == r) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* o = buf + g * D + d0 + e;
              *o = r == 0 ? acc[g][e] : *o + acc[g][e];
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- the live splits summed in rank order, normalized; each writes a
  // slice of the output
  cluster.sync();
  for (int i = tid; i < G * nl; i += THREADS) {
    const int g = i / nl, r = k.r_lo + i - g * nl;
    xt[i] = *cluster.map_shared_rank(&l_sh[g], r);
  }
  __syncthreads();
  if (tid < G) {
    float l = 0.f;
    for (int j = 0; j < nl; ++j) l += xt[tid * nl + j];
    e_sh[tid] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int o = (k.rank - k.r_lo) * THREADS + tid; o < G * D;
       o += nl * THREADS) {
    float v[MAX_SPLITS];                // every rank's read in flight at once
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      v[j] = j < nl ? *cluster.map_shared_rank(buf + o, k.r_lo + j) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) s += v[j];
    a.out[qoff + o] = s / e_sh[o / D];
  }
  cluster.sync();               // no block leaves while others read it
}

template <int KK, int VK, int GB>
int launch(const Args& a, int blocks, int splits, int smem, cudaStream_t st) {
  static bool configured = false;             // opt in once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<KK, VK, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_attn_kernel<KK, VK, GB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, paged_attn_kernel<KK, VK, GB>, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int KK, int VK>
int launch_g(const Args& a, int blocks, int splits, int smem,
             cudaStream_t st) {
  if (a.gc == 1) return launch<KK, VK, 1>(a, blocks, splits, smem, st);
  return launch<KK, VK, MAX_G>(a, blocks, splits, smem, st);
}


// --------------------------------------------------------------- mma template

constexpr int SC_MMA = 12288;        // scores a block of the mma template
                                     // keeps

// Rows [c0, c1) of a staged chunk of kind `kind` as bf16 rows of stride
// D + PAD in dst, dequantized and rounded to bf16 as the CUDA-core template
// rounds them (one rounding of the f32 product); rows outside the live
// range [a0, a1) zero where `dead0` (V rows: a zero weight must not meet a
// NaN).
__device__ __forceinline__ void to_bf16(const Args& a, const Blk& k, int kind,
                                        int c0, int c1, const uint8_t* st,
                                        __nv_bfloat16* dst, bool dead0) {
  const int D = a.d, KS = D + gqa::PAD, pieces = D / 8;
  const int rb = row_bytes(kind, D);
  const __nv_bfloat16* scl =
      reinterpret_cast<const __nv_bfloat16*>(st + a.off_scl);
#pragma unroll 4
  for (int p = threadIdx.x; p < (c1 - c0) * pieces; p += THREADS) {
    const int i = p / pieces, e0 = (p - i * pieces) * 8;
    const int pos = c0 + i;
    const uint8_t* row = st + i * rb;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (dead0 && (pos < k.a0 || pos >= k.a1)) {
      // zero
    } else if (kind == BF16) {
      w = *reinterpret_cast<const uint4*>(row + 2 * e0);
    } else {
      // q4: elements past D / 2 are the high nibbles of bytes e - D / 2
      const bool hi = kind == Q4 && e0 >= D / 2;
      const uint2 b = *reinterpret_cast<const uint2*>(
          row + (hi ? e0 - D / 2 : e0));
      const float s = kind >= Q8
          ? __bfloat162float(scl[i * (D / 32) + (e0 >> 5)]) : 0.f;
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t by = ((j < 4 ? b.x : b.y) >> (8 * (j & 3))) & 255u;
        if (kind == FP8) x[j] = fp8_val(by);
        else if (kind == Q8) x[j] = (float)((int)by - 128) * s;
        else x[j] = (float)((int)(hi ? by >> 4 : by & 15u) - 8) * s;
      }
      w = make_uint4(gqa::pack(x[0], x[1]), gqa::pack(x[2], x[3]),
                     gqa::pack(x[4], x[5]), gqa::pack(x[6], x[7]));
    }
    *reinterpret_cast<uint4*>(dst + i * KS + e0) = w;
  }
}

// Scores of the chunk rows [c0, c1) (bf16 in kb) into sc[g][pos - ws]
// (stride ss); NEG outside the live range. Warp w takes the n8 row tiles
// w, w + 4, ...: Q.K^T over the k16 steps of D, every m-tile of heads
// against the same K fragment.
template <int MT>
__device__ __forceinline__ void score_tiles(const Args& a, const Blk& k,
                                            int c0, int c1, int ws,
                                            const __nv_bfloat16* kb,
                                            const __nv_bfloat16* qs,
                                            float* sc, int ss) {
  const int D = a.d, KS = D + gqa::PAD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3, gq = lane >> 2;
  for (int n0 = 8 * warp; n0 < c1 - c0; n0 += 8 * WARPS) {
    float s[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
    for (int k0 = 0; k0 < D; k0 += 16) {
      uint32_t bk[2];
      gqa::b_frag(bk, kb, KS, n0, k0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t aq[4];
        gqa::a_frag(aq, qs, KS, 16 * mt, k0, lane);
        gqa::mma(s[mt], aq, bk);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = 16 * mt + gq + 8 * (j >> 1);
        const int pos = c0 + n0 + 2 * tq + (j & 1);
        if (g < k.g) {
          float x = s[mt][j] * a.scale;
          if (a.softcap > 0.f) x = tanhf(x * a.inv_softcap) * a.softcap;
          sc[g * ss + pos - ws] = pos >= k.a0 && pos < k.a1 ? x : NEG;
        }
      }
    }
  }
}

// score_tiles on a staged q4 chunk (rows of D / 2 bytes at st, their bf16
// scales at st + off_scl), its B fragments dequantized from the nibbles in
// registers: lane (gq, tq) of n8 tile n0 takes row n0 + gq, bytes kb + 2 tq
// (+1) and kb + 8 + 2 tq (+1) of each 16-byte step kb, whose low nibbles
// are elements kb + .. of k step kb and whose high nibbles those of k step
// D / 2 + kb. Each value is (nibble - 8) * s rounded to bf16, as to_bf16
// rounds it, so no bf16 rows are written and no barrier waits for them.
template <int MT>
__device__ __forceinline__ void score_tiles_q4(const Args& a, const Blk& k,
                                               int c0, int c1, int ws,
                                               const uint8_t* st,
                                               const __nv_bfloat16* qs,
                                               float* sc, int ss) {
  const int D = a.d, KS = D + gqa::PAD, H = D / 2, NS = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3, gq = lane >> 2;
  const __nv_bfloat16* scl =
      reinterpret_cast<const __nv_bfloat16*>(st + a.off_scl);
  for (int n0 = 8 * warp; n0 < c1 - c0; n0 += 8 * WARPS) {
    float s[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][e] = 0.f;
    const uint8_t* row = st + (n0 + gq) * H + 2 * tq;
    const __nv_bfloat16* rs = scl + (n0 + gq) * NS;
    for (int kb = 0; kb < H; kb += 16) {
      const uint32_t w =
          (uint32_t)*reinterpret_cast<const uint16_t*>(row + kb) |
          ((uint32_t)*reinterpret_cast<const uint16_t*>(row + kb + 8) << 16);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k0 = kb + hf * H;
        const uint32_t x = hf ? w >> 4 : w;
        const float sv = __bfloat162float(rs[k0 >> 5]);
        const auto val = [&](int sh) {
          return (float)((int)((x >> sh) & 15u) - 8) * sv;
        };
        const uint32_t bk[2] = {gqa::pack(val(0), val(8)),
                                gqa::pack(val(16), val(24))};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t aq[4];
          gqa::a_frag(aq, qs, KS, 16 * mt, k0, lane);
          gqa::mma(s[mt], aq, bk);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = 16 * mt + gq + 8 * (j >> 1);
        const int pos = c0 + n0 + 2 * tq + (j & 1);
        if (g < k.g) {
          float x = s[mt][j] * a.scale;
          if (a.softcap > 0.f) x = tanhf(x * a.inv_softcap) * a.softcap;
          sc[g * ss + pos - ws] = pos >= k.a0 && pos < k.a1 ? x : NEG;
        }
      }
    }
  }
}

// The ring of the mma template: chunk ci sits in stage ci % NST, its
// mbarrier's phase is (ci / NST) & 1, nx is the chunk the ring fetches next.
struct Ring {
  uint8_t* base;
  uint64_t* bars;
  Cur nx;
  int ci;
};

// waits for chunk ci and, once every thread is done with chunk ci - 1,
// starts the copy of the next chunk into its stage
__device__ __forceinline__ const uint8_t* consume(const Args& a,
                                                  const Blk& k,
                                                  const int* bts, Ring& r) {
  const int s = r.ci % NST;
  mbar_wait(&r.bars[s], (r.ci / NST) & 1);
  __syncthreads();
  const int s2 = (r.ci + NST - 1) % NST;
  issue(a, k, bts, r.nx, r.base + s2 * a.stage_bytes, &r.bars[s2], a.kk,
        a.vk);
  advance(a, k, r.nx);
  ++r.ci;
  return r.base + s * a.stage_bytes;
}

// the scores of the window [ws, we): each K chunk converted to bf16 rows,
// then scored on the tensor cores; a q4 chunk is scored from its nibbles
// as staged (consume's barrier keeps the stage until the next chunk)
template <int MT>
__device__ __forceinline__ void score_window(const Args& a, const Blk& k,
                                             const int* bts, Ring& r, int ws,
                                             int we, __nv_bfloat16* kvb,
                                             const __nv_bfloat16* qs,
                                             float* sc, int ss) {
  for (int c0 = ws; c0 < we; c0 += a.cr) {
    const int c1 = min(c0 + a.cr, we);
    const uint8_t* st = consume(a, k, bts, r);
    if (a.kk == Q4) {
      score_tiles_q4<MT>(a, k, c0, c1, ws, st, qs, sc, ss);
      continue;
    }
    to_bf16(a, k, a.kk, c0, c1, st, kvb, false);
    __syncthreads();
    score_tiles<MT>(a, k, c0, c1, ws, kvb, qs, sc, ss);
  }
  __syncthreads();
}

// The mma template: all G heads of a KV head in one block (MT m16 tiles);
// launch bounds of one block an SM (without a minimum, ptxas held three
// instantiations to 64-72 registers and spilled 24 bytes);
// NT: n8 output tiles a warp owns (D / 32, rounded up to 2, 4 or 8). The
// split, the ring, the cluster's exchange and merge are the CUDA-core
// template's; each staged chunk is dequantized into bf16 rows of stride
// D + PAD (kvb), from which scores and P.V run on the tensor cores.
template <int MT, int NT>
__global__ void __launch_bounds__(THREADS, 1) paged_attn_mma(const Args a) {
  constexpr int NH = 16 * MT;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float t_sh[NH], f_sh[NH], l_sh[NH], run_sh[NH];
  __shared__ float e_sh[NH], x_sh[NH], ml_sh[NH];
  __shared__ float xt[NH * MAX_SPLITS], xf[NH * MAX_SPLITS];
  __shared__ int bts[BT_MAX];
  __shared__ __align__(8) uint64_t bars[NST];
  const int D = a.d, KS = D + gqa::PAD, SS = a.wr + 8, NG = a.wr / 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* ring = smem + a.off_ring;
  __nv_bfloat16* kvb = reinterpret_cast<__nv_bfloat16*>(smem + a.off_kvb);
  float* sc = reinterpret_cast<float*>(smem + a.off_sc);     // [G][SS]
  float* mg = reinterpret_cast<float*>(smem + a.off_mg);     // [G][NG]
  cg::cluster_group cluster = cg::this_cluster();

  Blk k;
  k.b = blockIdx.x / (a.hkv * a.chunks);
  k.h = blockIdx.x / a.chunks % a.hkv;
  const int chunk = blockIdx.x % a.chunks;
  k.g = min(a.gc, a.g - chunk * a.gc);
  const int G = k.g, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, tq = lane & 3, gq = lane >> 2;
  k.rank = (int)cluster.block_rank();
  k.head = (size_t)a.layer * a.hkv + k.h;
  const int hq = a.hkv * a.g;
  const size_t qoff =
      ((size_t)k.b * hq + (size_t)k.h * a.g + (size_t)chunk * a.gc) * D;
  // the query rows (rows past G zero): loads in flight beside the block
  // table's, stored once those are issued
  gqa::QRows<NH> qr;
  gqa::q_load(qr, a.q + qoff, G, D, tid);
  if (tid < G) {
    t_sh[tid] = NEG;
    f_sh[tid] = NEG;
    l_sh[tid] = 0.f;
    run_sh[tid] = NEG;
  }
  const int n = a.vl[k.b];
  const int lo_abs = a.window > 0 ? max(n - a.window, 0) : 0;
  const int s0 = k.rank * a.per, s1 = min(s0 + a.per, a.pw * a.ps);
  k.a0 = max(s0, lo_abs);
  k.a1 = min(s1, n);
  k.live = k.a0 < k.a1;
  k.a0a = k.a0 & ~15;
  k.a1a = (k.a1 + 15) & ~15;
  k.keep = k.a1a - k.a0a <= a.wr;
  k.j0 = s0 / a.ps;
  k.jl = (s1 - 1) / a.ps;
  const int n_end = min(n, a.pw * a.ps);
  k.r_lo = lo_abs / a.per;
  k.r_hi = lo_abs < n_end ? (n_end - 1) / a.per + 1 : k.r_lo;
  k.tab = k.jl - k.j0 < BT_MAX;
  if (k.tab) {
    for (int i = tid; i <= k.jl - k.j0; i += THREADS)
      bts[i] = a.bt[(size_t)k.b * a.pw + k.j0 + i];
  }
  gqa::q_store(qr, qs, KS, D, tid);
  if (!k.live) {
    // as the CUDA-core template: leave at once; with no live row anywhere
    // rank 0 writes the zero output
    if (k.r_lo >= k.r_hi && k.rank == 0) {
      for (int o = tid; o < G * D; o += THREADS) a.out[qoff + o] = 0.f;
    }
    return;
  }
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // lane (gq, tq) holds rows (heads) 16 mt + gq + 8 hf of its columns
  // col0 + 8 nt + 2 tq (+1) of P.V; mcur: the page maximum they are
  // scaled to
  const int col0 = warp * (D / 4), nt_d = D / 32;
  float acc[MT][NT][4], mcur[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mcur[mt][0] = mcur[mt][1] = NEG;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  Ring rg = {ring, bars, {0, k.a0a, 0, k.a0a, false}, 0};
  rg.nx.we = win_end(a, k, k.a0a);
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    issue(a, k, bts, rg.nx, ring + s * a.stage_bytes, &bars[s], a.kk, a.vk);
    advance(a, k, rg.nx);
  }
  // ---- pass 0: scores, and per head T (all rows) and F (first page)
  for (int ws = k.a0a, we; ws < k.a1a; ws = we) {
    we = win_end(a, k, ws);
    score_window<MT>(a, k, bts, rg, ws, we, kvb, qs, sc, SS);
    for (int g = warp; g < G; g += WARPS) {
      for (int p0 = ws, pe; p0 < we; p0 = pe) {
        const int page = p0 / a.ps;
        pe = min(we, (page + 1) * a.ps);
        float mx = NEG;
        for (int r = p0 + lane; r < pe; r += 32)
          mx = fmaxf(mx, sc[g * SS + r - ws]);
        mx = warp_max(mx);
        if (lane == 0) {
          t_sh[g] = fmaxf(t_sh[g], mx);
          if (page == k.j0) f_sh[g] = fmaxf(f_sh[g], mx);
        }
      }
    }
  }

  // ---- exchange over the live ranks: E, X and M_last of every head
  const int nl = k.r_hi - k.r_lo;
  cluster.sync();
  for (int i = tid; i < G * nl; i += THREADS) {
    const int g = i / nl, r = k.r_lo + i - g * nl;
    xt[i] = *cluster.map_shared_rank(&t_sh[g], r);
    xf[i] = *cluster.map_shared_rank(&f_sh[g], r);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float e = NEG, x = NEG, ml = NEG;
    for (int j = 0; j < nl; ++j) {
      const int r = k.r_lo + j;
      const float t = xt[g * nl + j];
      ml = fmaxf(ml, t);
      if (r < k.rank) e = fmaxf(e, t);
      if (r > k.rank && r * a.per / a.ps == k.jl)
        x = fmaxf(x, xf[g * nl + j]);
    }
    e_sh[g] = e;
    x_sh[g] = x;
    ml_sh[g] = ml;
  }
  __syncthreads();

  // ---- pass 1: weights bf16(exp(s - M_j)) and each 16-row group's M_j,
  // l; then P.V on the tensor cores, the accumulator rescaled where M_j
  // changes (exp(M_j - M_j') <= 1) and by exp(M_jl - M_last) at the end
  for (int ws = k.a0a, we; ws < k.a1a; ws = we) {
    we = win_end(a, k, ws);
    if (!k.keep) score_window<MT>(a, k, bts, rg, ws, we, kvb, qs, sc, SS);
    for (int g = warp; g < G; g += WARPS) {
      const float e = e_sh[g], x = x_sh[g], ml = ml_sh[g];
      float run = run_sh[g], lsum = 0.f;
      for (int p0 = ws, pe; p0 < we; p0 = pe) {
        const int page = p0 / a.ps;
        pe = min(we, (page + 1) * a.ps);
        float mx = NEG;
        for (int r = p0 + lane; r < pe; r += 32)
          mx = fmaxf(mx, sc[g * SS + r - ws]);
        run = fmaxf(run, warp_max(mx));
        float mj = fmaxf(e, run);
        if (page == k.jl) mj = fmaxf(mj, x);
        const float fac = expf(mj - ml);
        for (int r = p0 + lane; r < pe; r += 32) {
          float* sp = sc + g * SS + r - ws;
          const bool ok = r >= k.a0 && r < k.a1;
          const float p = ok ? expf(*sp - mj) : 0.f;
          lsum += p * fac;
          *sp = rbf(p);
        }
        for (int q = (p0 - ws) / 16 + lane; q < (pe - ws) / 16; q += 32)
          mg[g * NG + q] = mj;
      }
      lsum = warp_sum(lsum);
      if (lane == 0) {
        l_sh[g] += lsum;
        run_sh[g] = run;
      }
    }
    for (int c0 = ws; c0 < we; c0 += a.cr) {
      const int c1 = min(c0 + a.cr, we);
      to_bf16(a, k, a.vk, c0, c1, consume(a, k, bts, rg), kvb, true);
      __syncthreads();
      for (int k0 = 0; k0 < c1 - c0; k0 += 16) {
        const int q = (c0 - ws + k0) / 16;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int g = 16 * mt + gq + 8 * hf;
            const float mj = g < G ? mg[g * NG + q] : NEG;
            if (mj != mcur[mt][hf]) {
              const float f = expf(mcur[mt][hf] - mj);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                acc[mt][nt][2 * hf] *= f;
                acc[mt][nt][2 * hf + 1] *= f;
              }
              mcur[mt][hf] = mj;
            }
          }
        }
        uint32_t ap[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          gqa::a_frag_f32(ap[mt], sc, SS, G, 16 * mt, c0 - ws + k0, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < nt_d) {
            uint32_t bv[2];
            gqa::b_frag_t(bv, kvb, KS, k0, col0 + 8 * nt, lane);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) gqa::mma(acc[mt][nt], ap[mt], bv);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- O scaled to M_last into buf [G][D] (the ring): each warp its
  // columns
  float* buf = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int g = 16 * mt + gq + 8 * hf;
      if (g >= G) continue;
      const float f = expf(mcur[mt][hf] - ml_sh[g]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_d)
          *reinterpret_cast<float2*>(buf + g * D + col0 + 8 * nt + 2 * tq) =
              make_float2(acc[mt][nt][2 * hf] * f,
                          acc[mt][nt][2 * hf + 1] * f);
      }
    }
  }
  __syncthreads();

  // ---- the live splits summed in rank order, normalized (as the
  // CUDA-core template)
  cluster.sync();
  for (int i = tid; i < G * nl; i += THREADS) {
    const int g = i / nl, r = k.r_lo + i - g * nl;
    xt[i] = *cluster.map_shared_rank(&l_sh[g], r);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float l = 0.f;
    for (int j = 0; j < nl; ++j) l += xt[g * nl + j];
    e_sh[g] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int o = (k.rank - k.r_lo) * THREADS + tid; o < G * D;
       o += nl * THREADS) {
    float v[MAX_SPLITS];                // every rank's read in flight at once
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j)
      v[j] = j < nl ? *cluster.map_shared_rank(buf + o, k.r_lo + j) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) s += v[j];
    a.out[qoff + o] = s / e_sh[o / D];
  }
  cluster.sync();               // no block leaves while others read it
}

template <int MT, int NT>
int launch_mma(const Args& a, int blocks, int splits, int smem,
               cudaStream_t st) {
  static bool clusters = false;               // opt in once
  static int opted = 0;                       // ... and to what a launch needs
  cudaError_t e = cudaSuccess;
  if (!clusters)
    e = cudaFuncSetAttribute(
        paged_attn_mma<MT, NT>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > opted)
    e = cudaFuncSetAttribute(paged_attn_mma<MT, NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  clusters = true;
  if (smem > opted) opted = smem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attn_mma<MT, NT>, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <int NT>
int launch_mt(const Args& a, int blocks, int splits, int smem,
              cudaStream_t st) {
  if (a.mt == 1) return launch_mma<1, NT>(a, blocks, splits, smem, st);
  if (a.mt == 2) return launch_mma<2, NT>(a, blocks, splits, smem, st);
  if (a.mt == 3) return launch_mma<3, NT>(a, blocks, splits, smem, st);
  return launch_mma<4, NT>(a, blocks, splits, smem, st);
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
// splits (<= 16) blocks of a cluster take `per` positions each (a multiple
// of 16; the last split may be shorter); the G query heads of a KV head go
// to ceil(G / gc) blocks of at most gc heads. mt: 0 for the CUDA-core
// template (1 <= gc <= 4), else the m16 tiles of the mma
// template (16 (mt - 1) < gc <= 16 mt, mt <= 4). Requires D % 32 == 0,
// D <= 256, page <= 256 and a multiple of 16, and the supported kind pairs
// (bf16, bf16), (fp8, fp8), (q8, q8), (q4, q4), (q8, q4). Returns the
// cudaError_t of the launch (0 on success).
int paged_decode_attention(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* bt,
                           const void* vl, int layer, int batch, int hkv,
                           int g, int gc, int mt, int d, int rows, int page,
                           int pw, float scale, float softcap, int window,
                           int kk, int vk, int splits, int per, void* out,
                           void* stream) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (d % 32 || d > 256 || g < 1 || gc < 1 || gc > g || mt < 0 ||
      mt > gqa::MAX_MT ||
      (mt == 0 && gc > MAX_G) ||
      (mt > 0 && (gc > 16 * mt || gc <= 16 * (mt - 1))) ||
      page < 16 || page > 256 || page % 16 || batch < 1 || hkv < 1 ||
      pw < 1 || kk < BF16 || kk > Q4 || vk < BF16 || vk > Q4 ||
      misaligned(k) || misaligned(v) ||
      (kk >= Q8 && (ks == nullptr || misaligned(ks))) ||
      (vk >= Q8 && (vs == nullptr || misaligned(vs))))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS || per < 16 || per % 16 ||
      (splits - 1) * per >= pw * page || splits * per < pw * page)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const uint8_t*)k;
  a.v = (const uint8_t*)v;
  a.ks = (const uint8_t*)ks;
  a.vs = (const uint8_t*)vs;
  a.bt = (const int*)bt;
  a.vl = (const int*)vl;
  a.layer = layer; a.hkv = hkv; a.g = g; a.d = d; a.rows = rows;
  a.gc = gc;
  a.chunks = (g + gc - 1) / gc;
  a.ps = page; a.pw = pw; a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.inv_softcap = softcap > 0.f ? (float)(1.0 / (double)softcap) : 0.f;
  a.out = (float*)out;
  a.per = per;
  a.kk = kk; a.vk = vk; a.mt = mt;
  const int kb = row_bytes(kk, d), vb = row_bytes(vk, d);
  const int mr = kb > vb ? kb : vb;
  const int scl = (kk >= Q8 || vk >= Q8) ? d / 16 : 0;    // scale bytes a row
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = batch * hkv * a.chunks;
  if (mt > 0) {
    // chunks sized as the CUDA-core template's (16 to 128 rows of the
    // staged kind), converted to bf16 rows of stride D + PAD (kvb); scores
    // of a window of wr rows (>= page, whole pages when it is not the
    // split's whole live range)
    const int chunk = per * mr >= 3 * CHUNK_LONG ? CHUNK_LONG : CHUNK_BYTES;
    a.cr = 16;
    while (a.cr * 2 <= THREADS && a.cr * 2 * mr <= chunk) a.cr *= 2;
    a.tpr = 0;
    a.swz = 0;
    a.off_scl = a.cr * mr;
    a.stage_bytes = (a.off_scl + a.cr * scl + 15) & ~15;
    int cap = (SC_MMA / gc) & ~15;
    if (cap < page) cap = page;
    a.wr = per < cap ? per : cap;
    const int ksz = d + gqa::PAD;
    a.off_ring = (16 * mt * ksz * 2 + 15) & ~15;
    int ring = NST * a.stage_bytes;
    if (ring < gc * d * 4) ring = gc * d * 4;         // the merge buffer
    a.off_kvb = a.off_ring + ring;
    a.off_sc = a.off_kvb + ((a.cr * ksz * 2 + 15) & ~15);
    a.off_mg = a.off_sc + gc * (a.wr + 8) * 4;
    const int smem = a.off_mg + gc * (a.wr / 16) * 4;
    if (smem > MAX_SMEM_MMA) return (int)cudaErrorInvalidValue;
    if (d <= 64) return launch_mt<2>(a, blocks, splits, smem, st);
    if (d <= 128) return launch_mt<4>(a, blocks, splits, smem, st);
    return launch_mt<8>(a, blocks, splits, smem, st);
  }
  // a chunk: the power of two of rows (16 .. THREADS) nearest below
  // CHUNK_BYTES of the wider row, CHUNK_LONG where a split holds three such
  // chunks (fewer, longer blocks stream faster with more in flight; short
  // splits keep the smaller ring and more blocks an SM); tpr lanes score a
  // K row
  const int chunk = per * mr >= 3 * CHUNK_LONG ? CHUNK_LONG : CHUNK_BYTES;
  a.cr = 16;
  while (a.cr * 2 <= THREADS && a.cr * 2 * mr <= chunk) a.cr *= 2;
  a.tpr = THREADS / a.cr;
  const int kch = kb / 16;
  a.swz = (kch & (kch - 1)) == 0 && kch >= a.tpr;
  const int rowsz = a.cr * mr;
  a.off_scl = rowsz;
  a.stage_bytes = (rowsz + a.cr * scl + 15) & ~15;
  // scores: a window of wr rows (>= page, whole pages when it is not the
  // split's whole live range)
  int cap = (SC_FLOATS / gc) & ~15;
  if (cap < page) cap = page;
  a.wr = per < cap ? per : cap;
  a.off_ring = (gc * d * 4 + 15) & ~15;
  int ring = NST * a.stage_bytes;
  if (ring < gc * d * 4) ring = gc * d * 4;         // the merge buffer
  a.off_sc = a.off_ring + ring;
  const int smem = a.off_sc + gc * a.wr * 4;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (kk == BF16 && vk == BF16)
    return launch_g<BF16, BF16>(a, blocks, splits, smem, st);
  if (kk == FP8 && vk == FP8)
    return launch_g<FP8, FP8>(a, blocks, splits, smem, st);
  if (kk == Q8 && vk == Q8)
    return launch_g<Q8, Q8>(a, blocks, splits, smem, st);
  if (kk == Q4 && vk == Q4)
    return launch_g<Q4, Q4>(a, blocks, splits, smem, st);
  if (kk == Q8 && vk == Q4)
    return launch_g<Q8, Q4>(a, blocks, splits, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
