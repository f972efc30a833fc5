// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 register-tiled on the CUDA cores.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel, _mask):
// online-softmax attention with causal / sliding / chunked / bidir masks,
// optional softcap c·tanh(s/c) before the mask, the scale d^-0.5, f32
// running max m, denominator l and accumulator, the finite mask value -1e30
// and the denominator clamped at 1e-30. q: (B,H,S,D), k/v: (B,KVH,S,D) with
// GQA head h reading KV head h / (H/KVH); out in q's type; any S.
//
// Bound on this card. At long S, operations: 4·D flops per attended (q,k)
// pair against 2·D·sizeof(T) bytes per key for the whole group of G = H/KVH
// query heads — at S=4096, D=128 causal, 120 GFLOP against ~67 MB. bf16
// reaches the tensor cores (989 TFLOP/s); f32 stays exact on the CUDA
// cores (67 TFLOP/s; TF32 is off by the port's rule). At the serving
// path's prefill (S=32) it moves ~1 MB and does ~15 MFLOP, under a
// microsecond either way: there a launch's latency and the host's cost of
// a call set the time.
//
// Rows of a block. The G query heads that share a KV head are packed into
// one block's rows, position-major: row r of a group is (position r / G,
// head r % G). A block owns BQ consecutive rows and loops over the group's
// K/V tiles, so a K/V tile is read once for every head of the group, a q
// tile spans only BQ/G positions (a narrow causal band), and a short S
// still fills the rows (S=32, G=7: 224 rows, 4 tiles per KV head instead
// of 28 half-empty ones). Tiles run heaviest first (blockIdx.y counts down
// the positions) so the causal tail overlaps them.
//
// Pipeline (both paths). K and V tiles of BK keys arrive by 16-byte
// cp.async, double buffered: tile i+1 is in flight while tile i is
// multiplied, issued just after the one barrier of tile i (which also
// frees tile i-1's buffer). Keys at or past S are zero-filled (cp.async with source size
// 0), so stale shared memory never meets a zero probability (0·NaN), and
// they are scored -inf, which gives them p = 0 exactly; rows past the
// group's G·S are computed on zeros and never stored.
//
// bf16 path (flash_bf16): 4 warps, each owning MT m16 tiles of rows (MT = 2,
// 128-row q tiles, when the grid still gives every SM two blocks; else
// MT = 1, 64-row tiles; MT = 1 at D = 256, where O alone is 128 registers
// a thread). Q·Kᵀ and P·V are mma.sync m16n8k16 bf16 -> f32; each K and V
// fragment feeds the warp's MT m-tiles. Tiles sit in shared memory with
// their 16-byte chunks XOR-swizzled within 128-byte lines, so ldmatrix
// (Q, K) and ldmatrix.trans (V) hit 32 distinct banks. The k tile is 64
// keys (32 at D = 256). The scale is applied to the f32 scores after Q·Kᵀ
// (a bf16 product is exact in the f32 accumulator, so this stays within
// f32 rounding of the reference's "scale q in f32, then dot"), together
// with log2(e): the softmax runs in the log2 domain on ex2.approx, with the
// mask value -1e30·log2(e), which keeps the reference's finite-mask
// semantics (s - m = 0 exactly for a row that has seen only masked keys).
// The softcap and the mask are decided per tile (template arguments), not
// predicated per element. S's accumulator fragment is packed to bf16 in
// registers as P's A fragment: P is rounded to bf16 before P·V, as an MXU
// product at default precision rounds it on the TPU, and the tolerance
// stays the reference's 2e-2; l sums the same rounded p, so the output is
// a convex combination of V rows. Row max and row sum are reduced over the
// quad of lanes that share a row (xor shuffles); the sum is kept per lane
// and reduced once at the end; O's rescale is skipped when no row max of
// the warp moved. The output goes through the warp's own Q rows in shared
// memory to 16-byte stores.
//
// What bounds the bf16 path on this card: mma.sync, not wgmma. mma.sync
// peaks near two thirds of the tensor cores' rate, and every m16n8k16 reads
// its B fragment (and Q's A fragment) from shared memory through ldmatrix,
// ~160 bytes a product at MT = 2, close to shared memory's 128 bytes a
// clock; the softmax's MUFU and FP32 work shares the warps' issue slots
// with the products. Warpgroup wgmma with TMA-fed tiles (as SDPA's kernel
// on this card does) is the next step.
//
// f32 path (flash_f32): 256 threads as 16 x 16; thread (tr, tc) owns query
// rows 4tr..4tr+3 and keys tc + 16j of each tile — a 4 x 4 register tile of
// S (4 x 2 at D = 256, BK = 32) from float4 reads of row-major Q and K in
// shared memory padded to D+4 floats (a quarter warp reads 8 consecutive
// K rows: 8 distinct bank groups; Q reads broadcast) — and the matching
// 4-row block of O over columns VW·tc + 16·VW·u. A row's 16 threads are one
// half warp, so its max and sum are xor shuffles and its P row goes through
// shared memory read by the same half warp (no block barrier). Exact f32
// FMA, expf, scale after the product.
//
// Skipped tiles. A tile none of whose (q, k) pairs is allowed (above the
// causal diagonal, older than the sliding window, in an earlier chunk) is
// not visited: the live tiles of a q tile form one contiguous range
// [kt0, kt1), found by tile_dead from both ends. Every row has an allowed
// key (k = q, window >= 1), which lies in a live tile. Before the first
// valid tile a dead tile would leave m = -1e30, l = 0, acc = 0 exactly as
// visiting it and being corrected away by corr = exp(-1e30 - m) = 0 would;
// after it, it would add exp(-1e30 - m) = 0 with corr = 1. So the outputs
// equal visiting every tile. A tile all of whose pairs are allowed and in
// range (tile_full) skips the per-element mask.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;      // rows of a q tile of the f32 path
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

enum Kind : int { kCausal = 0, kSliding = 1, kChunked = 2, kBidir = 3 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int h, kvh, s;
  float scale;
  int kind, window, chunk;
  float softcap;
  int has_softcap;
};

__device__ __forceinline__ bool allowed(const Params& p, int qp, int kp) {
  if (p.kind == kBidir) return true;
  bool ok = kp <= qp;
  if (p.kind == kSliding) ok = ok && kp > qp - p.window;
  else if (p.kind == kChunked) ok = ok && (kp / p.chunk) == (qp / p.chunk);
  return ok;
}

// True when no (q, k) pair with q in [q_lo, q_hi], k in [k_lo, k_hi] is
// allowed: every mask kind but bidir requires k <= q, sliding also
// k > q - window, chunked also the same chunk.
__device__ __forceinline__ bool tile_dead(const Params& p, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (p.kind == kBidir) return false;
  if (k_lo > q_hi) return true;
  if (p.kind == kSliding && k_hi <= q_lo - p.window) return true;
  if (p.kind == kChunked && k_hi / p.chunk < q_lo / p.chunk) return true;
  return false;
}

// True when every such pair is allowed.
__device__ __forceinline__ bool tile_full(const Params& p, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (p.kind == kBidir) return true;
  if (k_hi > q_lo) return false;
  if (p.kind == kSliding) return k_lo > q_hi - p.window;
  if (p.kind == kChunked) return k_lo / p.chunk == q_hi / p.chunk;
  return true;
}

// The block's q tile and its live k tiles.
struct Tile {
  int g, rows, r0, q_lo, q_hi, kt0, kt1;
  size_t q_base, kv_base;  // element offsets of the group's q and k/v planes
};

template <int D, int BQ, int BK>
__device__ __forceinline__ Tile block_tile(const Params& p) {
  Tile t;
  t.g = p.h / p.kvh;
  t.rows = t.g * p.s;
  const int b = blockIdx.x / p.kvh, kv = blockIdx.x % p.kvh;
  t.r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  t.q_lo = t.r0 / t.g;
  t.q_hi = (min(t.r0 + BQ, t.rows) - 1) / t.g;
  t.q_base = (static_cast<size_t>(b) * p.h + static_cast<size_t>(kv) * t.g) *
             p.s * D;
  t.kv_base = (static_cast<size_t>(b) * p.kvh + kv) * p.s * D;
  const int nk = (p.s + BK - 1) / BK;
  t.kt0 = 0;
  t.kt1 = nk;
  while (t.kt0 < t.kt1 &&
         tile_dead(p, t.q_lo, t.q_hi, t.kt0 * BK, min(t.kt0 * BK + BK, p.s) - 1))
    ++t.kt0;
  while (t.kt1 > t.kt0 &&
         tile_dead(p, t.q_lo, t.q_hi, (t.kt1 - 1) * BK,
                   min(t.kt1 * BK, p.s) - 1))
    --t.kt1;
  return t;
}

// Element offset of group row r (position r / g, head r % g) in q or o.
template <int D>
__device__ __forceinline__ size_t row_off(const Tile& t, int s, int r) {
  return (static_cast<size_t>(r % t.g) * s + r / t.g) * D;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------- bf16 path

// 16-byte chunk index of (row, chunk c) in a swizzled tile of CPR chunks a
// row: the chunk is XORed with the row within each 128-byte line, so the 8
// rows of an ldmatrix phase land in 8 distinct bank groups.
template <int CPR>
__device__ __forceinline__ int swz(int row, int c) {
  if constexpr (CPR >= 8) {
    return row * CPR + (c ^ (row & 7));
  } else {  // CPR == 4 (D = 32): two rows a line
    return row * CPR + (c ^ ((row >> 1) & 3));
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a·b, m16n8k16, bf16 inputs, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (relative error ~2^-22; -inf -> +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scores of one tile in the log2 domain: scale, softcap, mask (-1e30 for
// a masked pair, -inf past S), times log2(e). The softcap and the mask are
// template arguments: decided once per tile, not predicated per element.
template <bool kCap, bool kMask, int MT, int NT>
__device__ __forceinline__ void score_bf16(float (&sc)[MT][NT][4],
                                           const Params& p, int k0, int lane,
                                           const int (&pos)[MT][2]) {
  const float sl2 = p.scale * kLog2e;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v;
        if constexpr (kCap) {
          v = p.softcap * tanhf(sc[mt][j][e] * p.scale / p.softcap) * kLog2e;
        } else {
          v = sc[mt][j][e] * sl2;
        }
        if constexpr (kMask) {
          const int kp = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
          if (kp >= p.s) v = -INFINITY;
          else if (!allowed(p, pos[mt][e >> 1], kp)) v = kNeg * kLog2e;
        }
        sc[mt][j][e] = v;
      }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D, int BK, int MT>
struct Bf16Cfg {
  static constexpr int kThreads = 128;        // 4 warps
  static constexpr int BQ = 16 * MT * 4;      // each warp owns MT m16 tiles
  static constexpr int CPR = D / 8;           // 16-byte chunks a row
  static constexpr int kSmem = (BQ * D + 4 * BK * D) * 2;
};

template <int D, int BK, int MT>
__global__ void __launch_bounds__(128) flash_bf16(Params p) {
  using Cfg = Bf16Cfg<D, BK, MT>;
  constexpr int BQ = Cfg::BQ, CPR = Cfg::CPR;
  constexpr int NT = BK / 8;   // n-tiles of S
  constexpr int KS = D / 16;   // k-steps of Q·Kᵀ
  constexpr int ONT = D / 8;   // n-tiles of O
  extern __shared__ uint4 smem[];
  uint4* qs = smem;
  uint4* ks = qs + BQ * CPR;
  uint4* vs = ks + 2 * BK * CPR;

  const Tile t = block_tile<D, BQ, BK>(p);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + t.q_base;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + t.kv_base;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + t.kv_base;

  for (int i = tid; i < BQ * CPR; i += Cfg::kThreads) {
    const int row = i / CPR, c = i % CPR, r = t.r0 + row;
    const bool ok = r < t.rows;
    cp_async16(&qs[swz<CPR>(row, c)],
               ok ? qg + row_off<D>(t, p.s, r) + c * 8 : qg, ok);
  }
  auto load_kv = [&](int buf, int kt) {
    for (int i = tid; i < BK * CPR; i += Cfg::kThreads) {
      const int row = i / CPR, c = i % CPR, kp = kt * BK + row;
      const bool ok = kp < p.s;
      const size_t off = ok ? static_cast<size_t>(kp) * D + c * 8 : 0;
      const int at = buf * BK * CPR + swz<CPR>(row, c);
      cp_async16(&ks[at], kg + off, ok);
      cp_async16(&vs[at], vg + off, ok);
    }
  };
  if (t.kt0 < t.kt1) load_kv(0, t.kt0);
  cp_async_commit();

  // the warp's first row; the lane's rows are wr + 16·mt + (lane/4) (+8)
  const int wr = warp * 16 * MT;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  int pos[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    pos[mt][0] = (t.r0 + wr + 16 * mt + (lane >> 2)) / t.g;
    pos[mt][1] = (t.r0 + wr + 16 * mt + (lane >> 2) + 8) / t.g;
  }

  float o[MT][ONT][4];
  float m[MT][2], l[MT][2];  // m in the log2 domain, as the scores
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ONT; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = kNeg * kLog2e;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int kt = t.kt0; kt < t.kt1; ++kt) {
    // tile kt has landed and every warp is done with tile kt-1, whose
    // buffer the next tile's loads then refill: one barrier a tile
    const int buf = (kt - t.kt0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < t.kt1) {
      load_kv(buf ^ 1, kt + 1);
      cp_async_commit();
    }
    const uint4* kb = ks + buf * BK * CPR;
    const uint4* vb = vs + buf * BK * CPR;

    // S = Q·Kᵀ: each K fragment feeds the warp's MT m-tiles
    float sc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sc[mt][j][0] = sc[mt][j][1] = sc[mt][j][2] = sc[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], &qs[swz<CPR>(wr + 16 * mt + (mi & 1) * 8 + mr,
                                    kk * 2 + (mi >> 1))]);
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, &kb[swz<CPR>(n2 * 16 + (mi >> 1) * 8 + mr,
                                kk * 2 + (mi & 1))]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * n2], a[mt], b[0], b[1]);
          mma_bf16(sc[mt][2 * n2 + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // scale, softcap, mask, online softmax; P packed to bf16 in registers
    const int k0 = kt * BK;
    const bool full = k0 + BK <= p.s &&
                      tile_full(p, t.q_lo, t.q_hi, k0, k0 + BK - 1);
    if (p.has_softcap) {
      if (full) score_bf16<true, false>(sc, p, k0, lane, pos);
      else score_bf16<true, true>(sc, p, k0, lane, pos);
    } else {
      if (full) score_bf16<false, false>(sc, p, k0, lane, pos);
      else score_bf16<false, true>(sc, p, k0, lane, pos);
    }
    uint32_t pk[MT][NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        tm[0] = fmaxf(tm[0], fmaxf(sc[mt][j][0], sc[mt][j][1]));
        tm[1] = fmaxf(tm[1], fmaxf(sc[mt][j][2], sc[mt][j][3]));
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        tm[h2] = fmaxf(tm[h2], __shfl_xor_sync(0xffffffffu, tm[h2], 1));
        tm[h2] = fmaxf(tm[h2], __shfl_xor_sync(0xffffffffu, tm[h2], 2));
        const float mn = fmaxf(m[mt][h2], tm[h2]);
        const float corr = ex2(m[mt][h2] - mn);
        m[mt][h2] = mn;
        l[mt][h2] *= corr;
        // once the running maxima settle, corr is 1 for the whole warp and
        // the rescale of O (a multiply by one) is skipped
        if (!__all_sync(0xffffffffu, corr == 1.f)) {
#pragma unroll
          for (int j = 0; j < ONT; ++j) {
            o[mt][j][2 * h2] *= corr;
            o[mt][j][2 * h2 + 1] *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // l sums the bf16-rounded p that P·V multiplies, so the output
          // is a convex combination of V rows
          const __nv_bfloat162 pb = __floats2bfloat162_rn(
              ex2(sc[mt][j][2 * h2] - mn), ex2(sc[mt][j][2 * h2 + 1] - mn));
          const float2 pf = __bfloat1622float2(pb);
          l[mt][h2] += pf.x + pf.y;
          pk[mt][j][h2] = *reinterpret_cast<const uint32_t*>(&pb);
        }
      }
    }

    // O += P·V: each V fragment feeds the warp's MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_t(b, &vb[swz<CPR>(kk * 16 + (mi & 1) * 8 + mr,
                                  n2 * 2 + (mi >> 1))]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {pk[mt][2 * kk][0], pk[mt][2 * kk][1],
                                 pk[mt][2 * kk + 1][0], pk[mt][2 * kk + 1][1]};
          mma_bf16(o[mt][2 * n2], a, b[0], b[1]);
          mma_bf16(o[mt][2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // l over the quad; out through the warp's own Q rows to 16-byte stores
  uint32_t* qw = reinterpret_cast<uint32_t*>(qs);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float lv = l[mt][h2];
      lv += __shfl_xor_sync(0xffffffffu, lv, 1);
      lv += __shfl_xor_sync(0xffffffffu, lv, 2);
      inv[h2] = 1.f / fmaxf(lv, 1e-30f);
    }
    const int row = wr + 16 * mt + (lane >> 2);
#pragma unroll
    for (int j = 0; j < ONT; ++j) {
      qw[swz<CPR>(row, j) * 4 + (lane & 3)] =
          pack_bf16(o[mt][j][0] * inv[0], o[mt][j][1] * inv[0]);
      qw[swz<CPR>(row + 8, j) * 4 + (lane & 3)] =
          pack_bf16(o[mt][j][2] * inv[1], o[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + t.q_base;
  for (int i = lane; i < 16 * MT * CPR; i += 32) {
    const int row = wr + i / CPR, c = i % CPR, r = t.r0 + row;
    if (r < t.rows)
      *reinterpret_cast<uint4*>(og + row_off<D>(t, p.s, r) + c * 8) =
          qs[swz<CPR>(row, c)];
  }
}

// -------------------------------------------------------------- f32 path

// Scores of one tile of the f32 path (keys kt + 16·j): scale, softcap,
// mask, as score_bf16 but in the natural domain.
template <bool kCap, bool kMask, int KJ>
__device__ __forceinline__ void score_f32(float (&sc)[4][KJ], const Params& p,
                                          int kt, const int (&pos)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      float v = sc[i][j] * p.scale;
      if constexpr (kCap) v = p.softcap * tanhf(v / p.softcap);
      if constexpr (kMask) {
        const int kp = kt + 16 * j;
        if (kp >= p.s) v = -INFINITY;
        else if (!allowed(p, pos[i], kp)) v = kNeg;
      }
      sc[i][j] = v;
    }
}

template <int D, int BK>
struct F32Cfg {
  static constexpr int kThreads = 256;  // 16 x 16
  static constexpr int LD = D + 4;      // padded row of Q/K/V tiles (floats)
  static constexpr int LDP = BK + 4;    // padded row of the P tile
  static constexpr int kSmem =
      (kBQ * LD + 4 * BK * LD + kBQ * LDP) * 4;
};

template <int D, int BK>
__global__ void __launch_bounds__(256) flash_f32(Params p) {
  using Cfg = F32Cfg<D, BK>;
  constexpr int LD = Cfg::LD, LDP = Cfg::LDP;
  constexpr int KJ = BK / 16;             // keys of a thread per tile
  constexpr int VW = D >= 64 ? 4 : 2;     // O columns a read
  constexpr int NU = D / (16 * VW);       // O column groups a thread
  constexpr int CPR = D / 4;              // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * LD;
  float* vs = ks + 2 * BK * LD;
  float* ps = vs + 2 * BK * LD;

  const Tile t = block_tile<D, kBQ, BK>(p);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const float* qg = static_cast<const float*>(p.q) + t.q_base;
  const float* kg = static_cast<const float*>(p.k) + t.kv_base;
  const float* vg = static_cast<const float*>(p.v) + t.kv_base;

  for (int i = tid; i < kBQ * CPR; i += Cfg::kThreads) {
    const int row = i / CPR, c = i % CPR, r = t.r0 + row;
    const bool ok = r < t.rows;
    cp_async16(&qs[row * LD + c * 4],
               ok ? qg + row_off<D>(t, p.s, r) + c * 4 : qg, ok);
  }
  auto load_kv = [&](int buf, int kt) {
    for (int i = tid; i < BK * CPR; i += Cfg::kThreads) {
      const int row = i / CPR, c = i % CPR, kp = kt * BK + row;
      const bool ok = kp < p.s;
      const size_t off = ok ? static_cast<size_t>(kp) * D + c * 4 : 0;
      const int at = (buf * BK + row) * LD + c * 4;
      cp_async16(&ks[at], kg + off, ok);
      cp_async16(&vs[at], vg + off, ok);
    }
  };
  if (t.kt0 < t.kt1) load_kv(0, t.kt0);
  cp_async_commit();

  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = (t.r0 + 4 * tr + i) / t.g;
  float acc[4][NU][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][u][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNeg, l[i] = 0.f;

  for (int kt = t.kt0; kt < t.kt1; ++kt) {
    // tile kt has landed and every warp is done with tile kt-1, whose
    // buffer the next tile's loads then refill: one barrier a tile
    const int buf = (kt - t.kt0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < t.kt1) {
      load_kv(buf ^ 1, kt + 1);
      cp_async_commit();
    }
    const float* kb = ks + buf * BK * LD;
    const float* vb = vs + buf * BK * LD;

    float sc[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(4 * tr + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&kb[(tc + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    const int k0 = kt * BK;
    const bool full = k0 + BK <= p.s &&
                      tile_full(p, t.q_lo, t.q_hi, k0, k0 + BK - 1);
    if (p.has_softcap) {
      if (full) score_f32<true, false>(sc, p, k0 + tc, pos);
      else score_f32<true, true>(sc, p, k0 + tc, pos);
    } else {
      if (full) score_f32<false, false>(sc, p, k0 + tc, pos);
      else score_f32<false, true>(sc, p, k0 + tc, pos);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) tm = fmaxf(tm, sc[i][j]);
#pragma unroll
      for (int x = 1; x <= 8; x <<= 1)
        tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, x));
      const float mn = fmaxf(m[i], tm);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float pv = expf(sc[i][j] - mn);
        l[i] += pv;
        ps[(4 * tr + i) * LDP + tc + 16 * j] = pv;
      }
#pragma unroll
      for (int u = 0; u < NU; ++u)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[i][u][e] *= corr;
    }
    __syncwarp();  // a row's P is written and read by its own half warp

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&ps[(4 * tr + i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          float vv[VW];
          const float* src = &vb[(j + jj) * LD + VW * tc + 16 * VW * u];
          if constexpr (VW == 4) {
            const float4 w = *reinterpret_cast<const float4*>(src);
            vv[0] = w.x, vv[1] = w.y, vv[2] = w.z, vv[3] = w.w;
          } else {
            const float2 w = *reinterpret_cast<const float2*>(src);
            vv[0] = w.x, vv[1] = w.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y
                            : jj == 2 ? pr[i].z : pr[i].w;
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[i][u][e] = fmaf(pij, vv[e], acc[i][u][e]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  float* og = static_cast<float*>(p.o) + t.q_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int x = 1; x <= 8; x <<= 1) li += __shfl_xor_sync(0xffffffffu, li, x);
    const float inv = 1.f / fmaxf(li, 1e-30f);
    const int r = t.r0 + 4 * tr + i;
    if (r >= t.rows) continue;
    float* orow = og + row_off<D>(t, p.s, r);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      float* dst = orow + VW * tc + 16 * VW * u;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][u][0] * inv, acc[i][u][1] * inv,
                        acc[i][u][2] * inv, acc[i][u][3] * inv);
      } else {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[i][u][0] * inv, acc[i][u][1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------- launching

// Sets the kernel's dynamic shared-memory limit on the current device the
// first time it launches there (the attribute belongs to the device), then
// launches one block per (batch·KV head, q tile of the group's G·S rows).
template <typename K>
int launch(K kernel, int smem, int threads, int bq, const Params& p, int b,
           cudaStream_t st, bool (&attr_set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int rows = (p.h / p.kvh) * p.s;
  const dim3 grid(b * p.kvh, (rows + bq - 1) / bq);
  kernel<<<grid, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const Params& p, int b, int dtype, cudaStream_t st) {
  constexpr int BK = D == 256 ? 32 : 64;
  if (dtype == kBF16) {
    // two m-tiles a warp (128-row q tiles) halve the K/V fragment reads
    // per product; a grid too small to give every SM two such blocks
    // (short S) takes one (64-row tiles) for twice the blocks
    const long long blocks128 =
        static_cast<long long>(b) * p.kvh * ((p.h / p.kvh) * p.s / 128);
    if constexpr (D != 256) {  // two m-tiles and O at D = 256 would spill
      if (blocks128 >= 2 * 132) {
        using Cfg = Bf16Cfg<D, BK, 2>;
        static bool set[kMaxDevices] = {};
        return launch(flash_bf16<D, BK, 2>, Cfg::kSmem, Cfg::kThreads,
                      Cfg::BQ, p, b, st, set);
      }
    }
    using Cfg = Bf16Cfg<D, BK, 1>;
    static bool set[kMaxDevices] = {};
    return launch(flash_bf16<D, BK, 1>, Cfg::kSmem, Cfg::kThreads, Cfg::BQ,
                  p, b, st, set);
  }
  using Cfg = F32Cfg<D, BK>;
  static bool set[kMaxDevices] = {};
  return launch(flash_f32<D, BK>, Cfg::kSmem, Cfg::kThreads, kBQ, p, b, st,
                set);
}

}  // namespace

EXPORT_ERROR_STRING

// q/o: (b, h, s, d), k/v: (b, kvh, s, d), contiguous, 16-byte aligned, on
// the current device; dtype kF32 or kBF16 for all four.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int kvh, int s, int d, float scale,
                                      int kind, int window, int chunk,
                                      float softcap, int has_softcap,
                                      int dtype, void* stream) {
  if (b * h == 0 || s == 0) return 0;
  if (dtype != kF32 && dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, h, kvh, s, scale, kind, window, chunk, softcap,
           has_softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<32>(p, b, dtype, st);
    case 64: return launch_d<64>(p, b, dtype, st);
    case 128: return launch_d<128>(p, b, dtype, st);
    case 256: return launch_d<256>(p, b, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
