// Flash-attention forward for Hopper (sm_90a), FA2-style.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (_flash_kernel, _mask):
// online-softmax attention with causal / sliding / chunked / bidir masks,
// optional softcap c·tanh(s/c) before the mask, q scaled by d^-0.5 in f32,
// f32 running max m, denominator l and accumulator, the finite mask value
// -1e30 and the denominator clamped at 1e-30. q: (B,H,S,D), k/v:
// (B,KVH,S,D) with GQA head h reading KV head h / (H/KVH); out in q's type.
//
// Design. The TPU grid walks (batch·head, q-block, k-block) in order and
// carries m/l/acc in VMEM across the k axis. Here one block owns one
// (batch·head, 64-row q tile) and a loop over 64-key tiles replaces the
// sequential k axis, so the carry stays in registers. 256 threads: four
// per query row. Each thread scores 16 of the tile's 64 keys against its
// row (q and K tiles in shared memory, float4 reads, rows padded by four
// floats against bank conflicts), the row max and sum are reduced across
// the row's four lanes with shuffles, P goes through shared memory, and
// each thread accumulates D/4 output columns of P·V. K and V tiles share
// one shared buffer (K is consumed before V is loaded). All arithmetic is
// f32 on the CUDA cores; bf16 inputs are widened on load.
//
// The mask value stays the finite -1e30: a row whose first visited tile is
// fully masked then computes p = exp(0) on that tile and is corrected by
// corr = exp(-1e30 - m) = 0 once a valid key arrives; -inf would give
// exp(-inf + inf) = NaN. Tiles that are fully masked for the whole q tile
// (above the causal diagonal, older than the sliding window, in an earlier
// chunk) are skipped: before the first valid tile they leave m = -1e30,
// l = 0, acc = 0 exactly as visiting them and being corrected away would,
// and after it they add exp(-1e30 - m) = 0 with corr = 1, so the outputs
// are the same as visiting every tile.
//
// Bound on this card: at the serving path's prefill shape (B=1, H=28,
// KVH=4, S=32, D=128) it moves ~1 MB and does ~15 MFLOP, far below a
// microsecond either way; at long S it is bound by operations (4·D flops
// per attended (q,k) pair against 2·D·sizeof(T) bytes per key tile load).
// wgmma/TMA tiles are work for a later change; this kernel is exact first.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr int kTPR = 4;       // threads per query row
constexpr int kKPT = kBK / kTPR;  // keys scored per thread per tile
constexpr float kNeg = -1e30f;

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

// True when no (q, k) pair of the tile is allowed: every mask kind but
// bidir requires k <= q, sliding also k > q - window, chunked also the same
// chunk.
__device__ __forceinline__ bool tile_dead(const Params& p, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (p.kind == kBidir) return false;
  if (k_lo > q_hi) return true;
  if (p.kind == kSliding && k_hi <= q_lo - p.window) return true;
  if (p.kind == kChunked && k_hi / p.chunk < q_lo / p.chunk) return true;
  return false;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int s) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int pos = row0 + r;
    dst[r * LD + c] =
        pos < s ? to_f32(src[static_cast<size_t>(pos) * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  constexpr int LD = D + 4;     // padded row stride of q/K/V tiles (floats)
  constexpr int LDP = kBK + 4;  // padded row stride of the P tile
  constexpr int DPT = D / kTPR;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + kBQ * LD;
  float* ps = kv + kBK * LD;

  const int bh = blockIdx.x;
  const int b = bh / p.h, h = bh % p.h;
  const int kvh_idx = h / (p.h / p.kvh);
  const size_t plane = static_cast<size_t>(p.s) * D;
  const T* qg = static_cast<const T*>(p.q) + static_cast<size_t>(bh) * plane;
  const T* kg = static_cast<const T*>(p.k) +
                static_cast<size_t>(b * p.kvh + kvh_idx) * plane;
  const T* vg = static_cast<const T*>(p.v) +
                static_cast<size_t>(b * p.kvh + kvh_idx) * plane;
  T* og = static_cast<T*>(p.o) + static_cast<size_t>(bh) * plane;

  const int tid = threadIdx.x;
  const int row = tid / kTPR, sub = tid % kTPR;
  const int q0 = blockIdx.y * kBQ;
  const int qp = q0 + row;
  const int q_hi = min(q0 + kBQ, p.s) - 1;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int pos = q0 + r;
    qs[r * LD + c] =
        pos < p.s ? to_f32(qg[static_cast<size_t>(pos) * D + c]) * p.scale
                  : 0.f;
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  const int nk = (p.s + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    const int k_hi = min(k0 + kBK, p.s) - 1;
    if (tile_dead(p, q0, q_hi, k0, k_hi)) continue;  // uniform per block

    __syncthreads();  // previous tile's V and P reads are done
    load_tile<T, D>(kv, kg, k0, p.s);
    __syncthreads();

    float sc[kKPT];
#pragma unroll
    for (int t = 0; t < kKPT; ++t) sc[t] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(&qs[row * LD + c]);
#pragma unroll
      for (int t = 0; t < kKPT; ++t) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            &kv[(sub + kTPR * t) * LD + c]);
        sc[t] += q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w;
      }
    }

    float tmax = -INFINITY;  // over the tile's in-range keys only
#pragma unroll
    for (int t = 0; t < kKPT; ++t) {
      const int kp = k0 + sub + kTPR * t;
      float sv = sc[t];
      if (p.has_softcap) sv = p.softcap * tanhf(sv / p.softcap);
      if (!allowed(p, qp, kp)) sv = kNeg;
      sc[t] = sv;
      if (kp < p.s) tmax = fmaxf(tmax, sv);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kKPT; ++t) {
      const int j = sub + kTPR * t;
      const float pv = (k0 + j) < p.s ? expf(sc[t] - m_new) : 0.f;
      ps[row * LDP + j] = pv;
      psum += pv;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;

    __syncthreads();  // K reads done, P written
    load_tile<T, D>(kv, vg, k0, p.s);
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      const float pj = ps[row * LDP + j];
#pragma unroll
      for (int t = 0; t < DPT / 4; ++t) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            &kv[j * LD + sub * 4 + 4 * kTPR * t]);
        acc[4 * t + 0] += pj * v4.x;
        acc[4 * t + 1] += pj * v4.y;
        acc[4 * t + 2] += pj * v4.z;
        acc[4 * t + 3] += pj * v4.w;
      }
    }
  }

  if (qp < p.s) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = og + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int t = 0; t < DPT / 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        orow[sub * 4 + 4 * kTPR * t + e] = from_f32<T>(acc[4 * t + e] * inv);
      }
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int bh, cudaStream_t s) {
  constexpr int LD = D + 4;
  constexpr int kSmem = (kBQ * LD + kBK * LD + kBQ * (kBK + 4)) * 4;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(bh, (p.s + kBQ - 1) / kBQ);
  flash_fwd<T, D><<<grid, kThreads, kSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int bh, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, bh, s);
    case 64: return launch<T, 64>(p, bh, s);
    case 128: return launch<T, 128>(p, bh, s);
    case 256: return launch<T, 256>(p, bh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

EXPORT_ERROR_STRING

// q/o: (b, h, s, d), k/v: (b, kvh, s, d), contiguous, on the current device.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int kvh, int s, int d, float scale,
                                      int kind, int window, int chunk,
                                      float softcap, int has_softcap,
                                      int dtype, void* stream) {
  if (b * h == 0 || s == 0) return 0;
  Params p{q, k, v, o, h, kvh, s, scale, kind, window, chunk, softcap,
           has_softcap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(p, b * h, d, st);
  if (dtype == kBF16) return dispatch_d<__nv_bfloat16>(p, b * h, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
