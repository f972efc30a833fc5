// Mamba-2 SSD chunk scan for Hopper (sm_90a), from a zero state, in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). Per (batch·head row, chunk of L steps), with acum the
// inclusive cumsum of dt·A over the chunk and atot its last entry:
//   y_i = sum_{j<=i} (C_i·B_j) exp(clip(acum_i - acum_j, -60, 0)) dt_j x_j
//         + exp(clip(acum_i, -60, 0)) C_i·h
//   h  <- exp(atot) h + sum_j exp(clip(atot - acum_j, -60, 0)) dt_j x_j B_j^T
// x: (BH,S,hp), dt: (BH,S), A: (BH,), B/C: (BH/bc_div,S,ds) — row bh reads
// B/C row bh / bc_div, so the nh heads of a batch row share one copy —
// y: (BH,S,hp), h_out: (BH,hp,ds), the state after the last chunk (the
// carry the TPU kernel keeps in VMEM scratch; the prefill cache needs it).
//
// Bound on this card: operations. Per chunk, C·B^T and M·x over the
// L(L+1)/2 causal pairs, L(L+1)·(ds + hp) flops, + 4·L·hp·ds (carried term
// and state update) against (2·hp + 2·ds + 1)·L·4 bytes: ~21.0 MFLOP
// against ~0.4 MB at L=256, hp=64, ds=128, far above the f32 ridge of the
// CUDA cores.
//
// Design. The TPU grid walks (row, chunk) in order and keeps the (hp, ds)
// state in VMEM across the chunk axis; here one block owns one row and
// loops over its chunks in order, keeping the state in shared memory.
// The TPU kernel builds the whole L x L block C·B^T (256 KB at L=256), more
// than a block's 227 KB of shared memory, so the chunk is cut into 64-row
// tiles: for each row tile i, the causal column tiles j <= i form the 64x64
// tile of C·B^T, scale it by decay, dt_j and the causal mask into M, and add
// M·x_j to the tile's y (kept in shared memory); then the carried term reads
// the OLD state. Only after every row tile of the chunk has read it does
// the state update overwrite h. Every product is a 4x4 register tile per
// thread over operands read as float4 from shared memory (transposed tiles
// padded to 68 floats, so one warp's reads hit distinct banks or
// broadcast). All arithmetic is f32 on the CUDA cores; wgmma/TMA and the
// tensor cores are work for a later change.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows of a tile
constexpr int kTP = kT + 4;      // padded stride of a transposed tile
constexpr int kThreads = 256;

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* h_out;
  int s, L, hp, ds, bc_div;
};

// Shared-memory floats of one block (layout carved in ssd_scan_kernel).
__host__ __device__ inline size_t smem_floats(int L, int hp, int ds) {
  const size_t bt = static_cast<size_t>(ds) * kTP;          // B^T tile
  const size_t br = static_cast<size_t>(kT) * (ds + 4);     // B rows tile
  return static_cast<size_t>(ds) * kTP                      // C^T tile
         + (bt > br ? bt : br)                              // B tile
         + 2 * static_cast<size_t>(kT) * (hp + 4)           // x and y tiles
         + static_cast<size_t>(kT) * kTP                    // M^T tile
         + static_cast<size_t>(ds) * (hp + 4)               // h^T state
         + kT                                               // w_j
         + 2 * static_cast<size_t>(L);                      // dt, acum
}

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// Rows [0, nr) of a row-major (., D) matrix into sT[d][r] (stride kTP),
// zeros for rows nr..kT-1. A warp covers 4 rows x 8 columns, so its global
// reads are four 32-byte sectors and its shared stores hit 32 banks.
__device__ __forceinline__ void load_transposed(float* sT, const float* g,
                                                int nr, int D) {
  const int dgroups = D >> 3;
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int lane = e & 31, w = e >> 5;
    const int d = (w % dgroups) * 8 + (lane & 7);
    const int r = (w / dgroups) * 4 + (lane >> 3);
    sT[d * kTP + r] = r < nr ? g[static_cast<size_t>(r) * D + d] : 0.f;
  }
}

// Rows [0, nr) of a row-major (., D) matrix into s[r][d] (stride D + 4) as
// float4, zeros for rows nr..kT-1.
__device__ __forceinline__ void load_rows(float* s, const float* g, int nr,
                                          int D) {
  const int d4 = D >> 2;
  for (int e = threadIdx.x; e < kT * d4; e += kThreads) {
    const int r = e / d4, c = (e - r * d4) * 4;
    const float4 v =
        r < nr ? *reinterpret_cast<const float4*>(g + static_cast<size_t>(r) * D + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(s + r * (D + 4) + c) = v;
  }
}

__device__ __forceinline__ void unpack(const float4 v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int hp = p.hp, ds = p.ds, L = p.L;
  const int hpP = hp + 4, dsP = ds + 4;
  const size_t bt = static_cast<size_t>(ds) * kTP, br = static_cast<size_t>(kT) * dsP;
  float* sCt = reinterpret_cast<float*>(smem4);  // [s][i]  C tile^T
  float* sB = sCt + ds * kTP;                    // [s][j] B^T, or [j][s] B
  float* sX = sB + (bt > br ? bt : br);          // [j][p]  x tile
  float* sY = sX + kT * hpP;                     // [i][p]  y tile
  float* sM = sY + kT * hpP;                     // [j][i]  M^T
  float* sH = sM + kT * kTP;                     // [s][p]  state h^T
  float* sW = sH + ds * hpP;                     // [j]     w_j
  float* sDt = sW + kT;                          // [L]
  float* sAcum = sDt + L;                        // [L]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const float a = p.A[bh];
  const float* xg = p.x + static_cast<size_t>(bh) * p.s * hp;
  const float* dtg = p.dt + static_cast<size_t>(bh) * p.s;
  const size_t bc = static_cast<size_t>(bh / p.bc_div) * p.s * ds;
  const float* Bg = p.B + bc;
  const float* Cg = p.C + bc;
  float* yg = p.y + static_cast<size_t>(bh) * p.s * hp;
  const int nt = (L + kT - 1) / kT;
  const int hp4 = hp >> 2, ds4 = ds >> 2;
  const int ytiles = (kT / 4) * hp4, htiles = ds4 * hp4;

  for (int e = tid; e < ds * hpP; e += kThreads) sH[e] = 0.f;

  for (int c0 = 0; c0 < p.s; c0 += L) {
    __syncthreads();  // the previous chunk's readers of sDt/sAcum are done
    for (int i = tid; i < L; i += kThreads) sDt[i] = dtg[c0 + i];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < L; ++i) {
        run += sDt[i] * a;
        sAcum[i] = run;
      }
    }
    __syncthreads();
    const float atot = sAcum[L - 1];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT, ni = min(kT, L - i0);
      __syncthreads();  // the previous row tile's readers of sCt/sY are done
      load_transposed(sCt, Cg + static_cast<size_t>(c0 + i0) * ds, ni, ds);
      for (int e = tid; e < kT * hpP; e += kThreads) sY[e] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT, nj = min(kT, L - j0);
        __syncthreads();  // readers of sB/sX/sM of the last column tile done
        load_transposed(sB, Bg + static_cast<size_t>(c0 + j0) * ds, nj, ds);
        load_rows(sX, xg + static_cast<size_t>(c0 + j0) * hp, nj, hp);
        __syncthreads();
        {  // G = C_i·B_j^T as a 4x4 tile per thread, then M^T
          const int ti = tid >> 4, tj = tid & 15;
          float g[4][4] = {};
#pragma unroll 4
          for (int s = 0; s < ds; ++s) {
            float c[4], b[4];
            unpack(*reinterpret_cast<const float4*>(sCt + s * kTP + ti * 4), c);
            unpack(*reinterpret_cast<const float4*>(sB + s * kTP + tj * 4), b);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) g[r][q] = fmaf(c[r], b[q], g[r][q]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = tj * 4 + q;
            const bool jok = j < nj;
            const float dtj = jok ? sDt[j0 + j] : 0.f;
            const float aj = jok ? sAcum[j0 + j] : 0.f;
            float m[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = ti * 4 + r;
              const bool ok = jok && i < ni && i0 + i >= j0 + j;
              m[r] = ok ? g[r][q] * clip_exp(sAcum[i0 + i] - aj) * dtj : 0.f;
            }
            *reinterpret_cast<float4*>(sM + j * kTP + ti * 4) =
                make_float4(m[0], m[1], m[2], m[3]);
          }
        }
        __syncthreads();
        for (int t = tid; t < ytiles; t += kThreads) {  // y += M·x_j
          const int ti = t / hp4, tp = t - ti * hp4;
          float acc[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            unpack(*reinterpret_cast<const float4*>(sY + (ti * 4 + r) * hpP + tp * 4),
                   acc[r]);
#pragma unroll 4
          for (int j = 0; j < kT; ++j) {
            float m[4], xv[4];
            unpack(*reinterpret_cast<const float4*>(sM + j * kTP + ti * 4), m);
            unpack(*reinterpret_cast<const float4*>(sX + j * hpP + tp * 4), xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(m[r], xv[q], acc[r][q]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<float4*>(sY + (ti * 4 + r) * hpP + tp * 4) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
      __syncthreads();
      for (int t = tid; t < ytiles; t += kThreads) {  // + carried term, store
        const int ti = t / hp4, tp = t - ti * hp4;
        float acc[4][4] = {};
#pragma unroll 4
        for (int s = 0; s < ds; ++s) {
          float c[4], h[4];
          unpack(*reinterpret_cast<const float4*>(sCt + s * kTP + ti * 4), c);
          unpack(*reinterpret_cast<const float4*>(sH + s * hpP + tp * 4), h);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(c[r], h[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti * 4 + r;
          if (i >= ni) continue;
          const float cdec = clip_exp(sAcum[i0 + i]);
          float yv[4];
          unpack(*reinterpret_cast<const float4*>(sY + i * hpP + tp * 4), yv);
          *reinterpret_cast<float4*>(yg + static_cast<size_t>(c0 + i0 + i) * hp + tp * 4) =
              make_float4(yv[0] + cdec * acc[r][0], yv[1] + cdec * acc[r][1],
                          yv[2] + cdec * acc[r][2], yv[3] + cdec * acc[r][3]);
        }
      }
    }

    // every row tile has read the old state: h <- exp(atot)·h + injection
    __syncthreads();
    const float ea = expf(atot);
    for (int e = tid; e < ds * hpP; e += kThreads) sH[e] *= ea;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT, nj = min(kT, L - j0);
      __syncthreads();
      load_rows(sB, Bg + static_cast<size_t>(c0 + j0) * ds, nj, ds);
      load_rows(sX, xg + static_cast<size_t>(c0 + j0) * hp, nj, hp);
      for (int j = tid; j < kT; j += kThreads)
        sW[j] = j < nj ? clip_exp(atot - sAcum[j0 + j]) * sDt[j0 + j] : 0.f;
      __syncthreads();
      for (int t = tid; t < htiles; t += kThreads) {
        const int ts = t / hp4, tp = t - ts * hp4;
        float acc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          unpack(*reinterpret_cast<const float4*>(sH + (ts * 4 + r) * hpP + tp * 4),
                 acc[r]);
#pragma unroll 4
        for (int j = 0; j < kT; ++j) {
          const float w = sW[j];
          float b[4], xv[4];
          unpack(*reinterpret_cast<const float4*>(sB + j * dsP + ts * 4), b);
          unpack(*reinterpret_cast<const float4*>(sX + j * hpP + tp * 4), xv);
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] *= w;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(b[r], xv[q], acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(sH + (ts * 4 + r) * hpP + tp * 4) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
  __syncthreads();
  float* ho = p.h_out + static_cast<size_t>(bh) * hp * ds;
  for (int e = tid; e < hp * ds; e += kThreads) {
    const int pp = e / ds, s = e - pp * ds;
    ho[e] = sH[s * hpP + pp];
  }
}

}  // namespace

EXPORT_ERROR_STRING

// Dynamic shared memory one block needs, in bytes (the wrapper refuses
// shapes above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int L, int hp, int ds) {
  return static_cast<long long>(smem_floats(L, hp, ds) * sizeof(float));
}

// All pointers f32, contiguous, 16-byte aligned, on the current device;
// hp % 4 == 0, ds % 8 == 0, s % L == 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* h_out, int bh, int s, int L, int hp,
                               int ds, int bc_div, void* stream) {
  if (bh == 0 || s == 0) return 0;
  const size_t smem = smem_floats(L, hp, ds) * sizeof(float);
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A),  static_cast<const float*>(B),
           static_cast<const float*>(C),  static_cast<float*>(y),
           static_cast<float*>(h_out),    s, L, hp, ds, bc_div};
  ssd_scan_kernel<<<bh, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
