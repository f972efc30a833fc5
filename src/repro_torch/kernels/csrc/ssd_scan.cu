// Mamba-2 SSD chunk scan for Hopper (sm_90a), from a zero state, in f32.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). Per (batch·head row, chunk of L steps), with acum the
// inclusive cumsum of dt·A over the chunk and atot its last entry:
//   y_i = sum_{j<=i} (C_i·B_j) exp(clip(acum_i - acum_j, -60, 0)) dt_j x_j
//         + exp(clip(acum_i, -60, 0)) C_i·h
//   h  <- exp(atot) h + sum_j exp(clip(atot - acum_j, -60, 0)) dt_j x_j B_j^T
// x: (BH,S,hp), dt: (BH,S), A: (BH,), B/C: (groups,S,ds) — row bh reads
// B/C row bh / bc_div (bc_div = BH / groups), so the nh heads of a batch row
// share one copy — y: (BH,S,hp), h_out: (BH,hp,ds), the state after the
// last chunk (the carry the TPU kernel keeps in VMEM scratch; the prefill
// cache needs it).
//
// Bound on this card: operations. The least work these inputs need counts
// C·B^T once per (B/C row, chunk) over its L(L+1)/2 causal pairs, and per
// (row, chunk) the causal M·x, the carried term C·h and the state update:
//   groups·nc·L(L+1)·ds + BH·nc·(L(L+1)·hp + 4·L·hp·ds)  flops
// = 19.62 GFLOP at the Mamba-2 prefill (BH 192, groups 4, S 2048, L 256,
// hp 64, ds 128), 0.293 ms at the CUDA cores' 67 TFLOP/s, against 218 MB
// (0.065 ms at 3.35 TB/s).
//
// Design: the SSD algorithm's chunk-parallel form (the reference model's
// _ssd_chunked, repro/models/ssm.py; Mamba-2, arXiv:2405.21060 §6-7), as
// four kernels on one stream. The TPU kernel walks each row's chunks in
// order with the state in VMEM; here only the elementwise state passing
// (c) is sequential over chunks, and everything with a product is parallel
// over (row, chunk):
//   (a) cb_kernel: G^T = (C·B^T)^T of each (B/C row, chunk), the causal
//       64 x 64 tiles only, into a (groups, nc, L, L) scratch that the
//       heads of a batch row share (8.4 MB at the prefill: it stays in
//       L2); its diagonal blocks also write C^T into a (groups, nc, ds, L)
//       scratch; more blocks write acum into a (BH, S) scratch, a warp
//       per (row, chunk) adding dt·A step by step (fused multiply-add), as
//       the reference's cumsum runs;
//   (b) state_kernel: per (row, chunk, 64-wide ds tile, 64-wide hp tile),
//       the chunk's own state contribution S_c^T = sum_j (w_j B_j)^T x_j
//       into a (BH, nc, ds, hp) scratch;
//   (c) pass_kernel: per 32 x 32 (ds, hp) tile of a row, over the row's
//       chunks in order, h_c = exp(atot_c)·h_{c-1} + S_c; the state
//       entering chunk c overwrites S_c^T in place, the last one is h_out;
//   (d) out_kernel: per (row, chunk, 64-row tile, 64-wide hp tile), the
//       carried term cdec_i·C_i·h_in first (C^T and h_in^T read by rows),
//       then the causal column tiles of M = G∘decay∘dt (built in shared
//       memory from G^T) times x, the diagonal tile cut short per warp.
// Stream order makes (d) read G, C^T and the incoming states only after
// (a) and (c) wrote them. Every product is a 64 x 64 tile of a 128-thread
// block, an 8 x 4 register tile a thread, over operands read as float4
// from padded shared memory (stride 68: a quarter-warp broadcasts its a
// operand and reads 128 contiguous bytes of b). Operand tiles arrive by
// cp.async, all of a step's copies in flight together; depth steps of 64
// (32 over ds in (a)), so a block's shared memory (< 36 KB) does not grow
// with L, hp or ds, and the ragged edges of L, hp and ds are masked (zeros
// in shared memory, no store); 16-byte copies where a row's length is a
// multiple of 4 floats, 4-byte ones elsewhere. f32 on the CUDA cores.
// Measured at the prefill shape on the H100 (PERF.md): 4 x 4 tiles at 256
// threads, 8 x 8 at 64, and double-buffered copies (which halve the blocks
// an SM holds) were all slower than this; 4-byte transposing loads of C
// and h cost (d) more than its C·h product, hence the C^T and S_c^T
// layouts. The tensor cores (an error-compensated 3xTF32 split) are the
// next lever.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows and columns of a tile
constexpr int kTP = kT + 4;      // padded stride of a shared tile
constexpr int kS = 32;           // ds depth of one step of (a)'s C·B^T
constexpr int kTR = 8;           // rows of a thread's register tile
constexpr int kTC = 4;           // columns of a thread's register tile
constexpr int kThreads = (kT / kTR) * (kT / kTC);
constexpr int kTileF = kT * kTP;  // floats of one shared tile
constexpr int kPassThreads = 256;
constexpr int kPT = 32;          // (c) works on 32 x 32 (s, p) tiles
constexpr int kPass = 8;         // chunks whose loads (c) issues together
// Shared floats of (b) and (d): two operand tiles and the acum and dt of
// the step's (column) tile, 34.5 KB, under the 48 KB a block may declare
// statically.
constexpr int kPairSmemF = 2 * (kTileF + kT);
static_assert(kThreads >= kT && kThreads % kT == 0,
              "a thread per step of a product tile, per column of (d)'s tile");

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* h_out;
  float* acum;   // (BH, S): dt·A cumsum within each chunk
  float* gt;     // (groups, nc, L, L): [j][i] = C_i·B_j for j, i in a causal tile
  float* ct;     // (groups, nc, ds, L): C^T of each chunk
  float* st;     // (BH, nc, ds, hp): S_c^T from (b), the incoming state after (c)
  int bh, s, L, hp, ds, bc_div, nc, nt;
  int vx, vb, vg;  // 16-byte loads of x (hp % 4 == 0), B (ds % 4), G^T (L % 4)
};

__device__ __forceinline__ float clip_exp(float v) {
  return expf(fminf(fmaxf(v, -60.f), 0.f));
}

// Asynchronous copy (cp.async) of kBytes (4 or 16) from global src to
// shared dst, zeros when !ok (src is then not read). The copies a thread
// issues land after cp_commit and cp_wait_all; a barrier then shows them
// to the block.
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until every copy the thread committed has landed.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [0, nr) x columns [0, nc) of a row-major matrix (row stride ld) at
// g into s[r][c] (stride kTP) for r, c < kT, zeros elsewhere, by cp.async;
// 16-byte words when vec (ld, nc and g's alignment multiples of 4 floats).
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int nr, int nc, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kT * (kT / 4); e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool ok = r < nr && c < nc;
      cp_async<16>(s + r * kTP + c, ok ? g + static_cast<size_t>(r) * ld + c : g, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e >> 6, c = e & (kT - 1);
      const bool ok = r < nr && c < nc;
      cp_async<4>(s + r * kTP + c, ok ? g + static_cast<size_t>(r) * ld + c : g, ok);
    }
  }
}

// Rows [0, nr) x columns [0, nc) of a row-major matrix (row stride ld) at
// g into sT[c][r] (stride kTP) for c < kS, r < kT, zeros elsewhere, by
// 4-byte cp.async. A warp covers 4 rows x 8 columns: four 32-byte sectors
// read, 32 banks written.
__device__ __forceinline__ void load_T(float* sT, const float* g, int ld,
                                       int nr, int nc) {
  for (int e = threadIdx.x; e < kT * kS; e += kThreads) {
    const int lane = e & 31, w = e >> 5;
    const int c = (w & (kS / 8 - 1)) * 8 + (lane & 7);
    const int r = (w / (kS / 8)) * 4 + (lane >> 3);
    const bool ok = r < nr && c < nc;
    cp_async<4>(sT + c * kTP + r, ok ? g + static_cast<size_t>(r) * ld + c : g, ok);
  }
}

// kT values of a row from g into s[0, kT), zeros past n, by cp.async.
__device__ __forceinline__ void load_row(float* s, const float* g, int n) {
  for (int e = threadIdx.x; e < kT; e += kThreads)
    cp_async<4>(s + e, e < n ? g + e : g, e < n);
}

// Column of entry q of a thread's register tile: thread index t owns 4
// consecutive columns in each of the kTC / 4 parts of the 64-wide tile,
// so the threads of a quarter-warp read consecutive float4 of the b
// operand. Rows are contiguous (thread index t owns rows t·kTR ..
// t·kTR + kTR - 1): a quarter-warp shares its row index, and its reads of
// the a operand are broadcasts.
__device__ __forceinline__ int col_at(int t, int q) {
  return (q >> 2) * (kT * 4 / kTC) + t * 4 + (q & 3);
}

// acc[r][q] += sum_{k < kn} a[k][ti·kTR + r] · b[k][col_at(tj, q)]
// (operands [k][.] at stride kTP); with kW, the a operand of step k is
// scaled by w[k] first.
template <bool kW>
__device__ __forceinline__ void mma_tile(float (&acc)[kTR][kTC],
                                         const float* a, const float* b,
                                         const float* w, int ti, int tj,
                                         int kn) {
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float av[kTR], bv[kTC];
#pragma unroll
    for (int u = 0; u < kTR / 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(
          a + k * kTP + ti * kTR + 4 * u);
      av[4 * u] = v.x; av[4 * u + 1] = v.y; av[4 * u + 2] = v.z; av[4 * u + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < kTC / 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(
          b + k * kTP + col_at(tj, 4 * u));
      bv[4 * u] = v.x; bv[4 * u + 1] = v.y; bv[4 * u + 2] = v.z; bv[4 * u + 3] = v.w;
    }
    if (kW) {
      const float wk = w[k];
#pragma unroll
      for (int r = 0; r < kTR; ++r) av[r] *= wk;
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int q = 0; q < kTC; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// Stores a thread's register tile acc (rows ti·kTR + r, columns
// col_at(tj, q)) into the row-major out (row stride ld), rows < nr and
// columns < nc only; float4 words when vec (ld, nc multiples of 4).
__device__ __forceinline__ void store_tile(float* out, size_t ld, int nr,
                                           int nc, bool vec,
                                           const float (&acc)[kTR][kTC],
                                           int ti, int tj) {
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int row = ti * kTR + r;
    if (row >= nr) continue;
#pragma unroll
    for (int u = 0; u < kTC / 4; ++u) {
      const int col = col_at(tj, 4 * u);
      float* o = out + row * ld + col;
      const float* v = acc[r] + 4 * u;
      if (vec && col < nc) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < nc) o[q] = v[q];
      }
    }
  }
}

// acum of chain q = row·nc + c, the cumsum of dt·a over chunk c of row
// row, by one warp: the chain is added step by step with a fused
// multiply-add, as the reference's cumsum runs, so neighbouring entries
// differ by one rounding. The decays of nearby steps, exp(acum_i - acum_j)
// with acum ~ 1e3, are the largest weights and need that; a parallel tree
// scan, whose neighbours come from different trees, failed chip_smoke.py's
// Mamba-2 prefill-vs-token-by-token check (2.9x this chain's error in the
// last logits, H100). The warp loads 32 steps of dt at
// a time, every lane runs the same chain over them (shuffled from the lane
// that loaded each) and keeps its own step's entry, so loads and stores
// are coalesced.
__device__ __forceinline__ void cumsum_chain(const Params& p, long long q) {
  if (q >= static_cast<long long>(p.bh) * p.nc) return;
  const int lane = threadIdx.x & 31;
  const int row = static_cast<int>(q / p.nc), c = static_cast<int>(q % p.nc);
  const size_t t0 = static_cast<size_t>(row) * p.s + static_cast<size_t>(c) * p.L;
  const float a = p.A[row];
  const float* dtg = p.dt + t0;
  float* ac = p.acum + t0;
  float run = 0.f;
  for (int i0 = 0; i0 < p.L; i0 += 32) {
    const int n = min(32, p.L - i0);
    const float d = lane < n ? dtg[i0 + lane] : 0.f;
    float mine = 0.f;
    for (int u = 0; u < n; ++u) {
      run = fmaf(__shfl_sync(0xffffffffu, d, u), a, run);
      if (lane == u) mine = run;
    }
    if (lane < n) ac[i0 + lane] = mine;
  }
}

// A block's product steps 0..n-1: issue(k) starts the cp.async copies of
// step k's operands, compute(k) uses them once they have landed. The
// copies of a step are issued together, so their latencies overlap; a
// second buffer, to overlap them with the step before, would halve the
// blocks an SM holds and measured slower.
template <typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int n, Issue issue, Compute compute) {
  for (int k = 0; k < n; ++k) {
    issue(k);
    cp_commit();
    cp_wait_all();
    __syncthreads();  // step k's operands are visible
    compute(k);
    __syncthreads();  // step k's buffers are free
  }
}

// (a) G^T of one causal tile pair (it, jt), jt <= it, of one (B/C row,
// chunk): [j][i] = sum_s B_j[s] C_i[s], over ds steps of kS. The diagonal
// pairs (it == jt) also write the C^T tiles they load, for (d). The blocks
// past the tile pairs compute acum, a warp per (row, chunk).
__global__ void __launch_bounds__(kThreads) cb_kernel(const Params p) {
  __shared__ __align__(16) float sBt[kS * kTP];  // [s][j]
  __shared__ __align__(16) float sCt[kS * kTP];  // [s][i]
  const int L = p.L, ds = p.ds, tid = threadIdx.x;
  const long long npairs = static_cast<long long>(p.nt) * (p.nt + 1) / 2;
  const long long n_tiles = static_cast<long long>(p.bh / p.bc_div) * p.nc * npairs;
  if (blockIdx.x >= n_tiles) {
    cumsum_chain(p, (blockIdx.x - n_tiles) * (kThreads / 32) + tid / 32);
    return;
  }
  const long long gc = blockIdx.x / npairs;  // g·nc + c
  const int pair = static_cast<int>(blockIdx.x - gc * npairs);
  int it = static_cast<int>((sqrtf(8.f * pair + 1.f) - 1.f) * 0.5f);
  while ((it + 1) * (it + 2) / 2 <= pair) ++it;
  while (it * (it + 1) / 2 > pair) --it;
  const int jt = pair - it * (it + 1) / 2;
  const int g = static_cast<int>(gc / p.nc), c = static_cast<int>(gc % p.nc);
  const int i0 = it * kT, j0 = jt * kT;
  const int ni = min(kT, L - i0), nj = min(kT, L - j0);
  const size_t t0 = static_cast<size_t>(g) * p.s + static_cast<size_t>(c) * L;
  const float* Cg = p.C + (t0 + i0) * ds;
  const float* Bg = p.B + (t0 + j0) * ds;
  const int ti = tid / (kT / kTC), tj = tid % (kT / kTC);
  float acc[kTR][kTC] = {};
  pipeline(
      (ds + kS - 1) / kS,
      [&](int k) {
        const int s0 = k * kS;
        load_T(sBt, Bg + s0, ds, nj, min(kS, ds - s0));
        load_T(sCt, Cg + s0, ds, ni, min(kS, ds - s0));
      },
      [&](int k) {
        mma_tile<false>(acc, sBt, sCt, nullptr, ti, tj, kS);
        if (it != jt) return;
        const int s0 = k * kS, ns = min(kS, ds - s0);
        float* out = p.ct + (static_cast<size_t>(gc) * ds + s0) * L + i0;
        for (int e = tid; e < kS * kT; e += kThreads) {
          const int sr = e >> 6, i = e & (kT - 1);
          if (sr < ns && i < ni)
            out[static_cast<size_t>(sr) * L + i] = sCt[sr * kTP + i];
        }
      });
  store_tile(p.gt + (static_cast<size_t>(gc) * L + j0) * L + i0, L, nj, ni,
             p.vg, acc, ti, tj);
}

// (b) a chunk's own state contribution, transposed so that (d) reads it
// by rows: S_c^T[s][p] = sum_j (w_j B_j[s]) x_j[p] with
// w_j = clip_exp(atot - acum_j)·dt_j, for one 64 x 64 (ds, hp) tile.
__global__ void __launch_bounds__(kThreads) state_kernel(const Params p) {
  __shared__ __align__(16) float smem[kPairSmemF];
  float* sB = smem;                // B [j][s]
  float* sX = smem + kTileF;       // x [j][p]
  float* sAc = smem + 2 * kTileF;  // acum of the step's tile
  float* sDt = sAc + kT;           // dt of the step's tile
  __shared__ float sW[kT];
  const int L = p.L, hp = p.hp, ds = p.ds, tid = threadIdx.x;
  const long long rc = blockIdx.x;  // row·nc + c
  const int row = static_cast<int>(rc / p.nc), c = static_cast<int>(rc % p.nc);
  const int s0 = blockIdx.y * kT, p0 = blockIdx.z * kT;
  const size_t t0 = static_cast<size_t>(row) * p.s + static_cast<size_t>(c) * L;
  const float* acg = p.acum + t0;
  const float* dtg = p.dt + t0;
  const float* xg = p.x + t0 * hp + p0;
  const float* Bg = p.B + (static_cast<size_t>(row / p.bc_div) * p.s +
                           static_cast<size_t>(c) * L) * ds + s0;
  const float atot = acg[L - 1];
  const int ti = tid / (kT / kTC), tj = tid % (kT / kTC);
  float acc[kTR][kTC] = {};
  pipeline(
      (L + kT - 1) / kT,
      [&](int k) {
        const int j0 = k * kT, nj = min(kT, L - j0);
        load_tile(sX, xg + static_cast<size_t>(j0) * hp, hp, nj, hp - p0, p.vx);
        load_tile(sB, Bg + static_cast<size_t>(j0) * ds, ds, nj, ds - s0, p.vb);
        load_row(sAc, acg + j0, nj);
        load_row(sDt, dtg + j0, nj);
      },
      [&](int k) {
        if (tid < kT)
          sW[tid] = k * kT + tid < L ? clip_exp(atot - sAc[tid]) * sDt[tid] : 0.f;
        __syncthreads();  // sW is visible
        mma_tile<true>(acc, sB, sX, sW, ti, tj, kT);
      });
  store_tile(p.st + (static_cast<size_t>(rc) * ds + s0) * hp + p0, hp,
             ds - s0, hp - p0, p.vx, acc, ti, tj);
}

// (c) one 32 x 32 (s, p) tile of one row's state a block: h over the
// row's chunks in order, elementwise; the state entering chunk c replaces
// S_c^T, the last state goes to h_out in its (hp, ds) layout through a
// shared tile, so that both the reads and the writes are coalesced. The
// loads of kPass chunks are issued before their stores, so they are in
// flight together.
__global__ void __launch_bounds__(kPassThreads) pass_kernel(const Params p) {
  constexpr int kE = kPT * kPT / kPassThreads;  // elements of a thread
  __shared__ float sH[kPT][kPT + 1];
  const int hp = p.hp, ds = p.ds, nc = p.nc, tid = threadIdx.x;
  const int row = blockIdx.x, s0 = blockIdx.y * kPT, p0 = blockIdx.z * kPT;
  const size_t hd = static_cast<size_t>(hp) * ds;
  float* st = p.st + static_cast<size_t>(row) * nc * hd;
  const float* __restrict__ atot =
      p.acum + static_cast<size_t>(row) * p.s + (p.L - 1);
  size_t at[kE];  // offsets of a thread's elements in S_c^T
  bool ok[kE];
#pragma unroll
  for (int v = 0; v < kE; ++v) {
    const int e = tid + v * kPassThreads, sl = e / kPT, pl = e % kPT;
    ok[v] = s0 + sl < ds && p0 + pl < hp;
    at[v] = static_cast<size_t>(s0 + sl) * hp + p0 + pl;
  }
  float h[kE] = {};
  for (int c0 = 0; c0 < nc; c0 += kPass) {
    float ea[kPass], sc[kPass][kE];
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      if (c0 + u >= nc) continue;
      ea[u] = atot[static_cast<size_t>(c0 + u) * p.L];
#pragma unroll
      for (int v = 0; v < kE; ++v)
        sc[u][v] = ok[v] ? st[(c0 + u) * hd + at[v]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPass; ++u) {
      if (c0 + u >= nc) continue;
      const float decay = expf(ea[u]);
#pragma unroll
      for (int v = 0; v < kE; ++v) {
        if (ok[v]) st[(c0 + u) * hd + at[v]] = h[v];
        h[v] = decay * h[v] + sc[u][v];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kE; ++v) {
    const int e = tid + v * kPassThreads;
    sH[e / kPT][e % kPT] = h[v];
  }
  __syncthreads();
  float* ho = p.h_out + static_cast<size_t>(row) * hd;
#pragma unroll
  for (int v = 0; v < kE; ++v) {
    const int e = tid + v * kPassThreads, pl = e / kPT, sl = e % kPT;
    if (p0 + pl < hp && s0 + sl < ds)
      ho[static_cast<size_t>(p0 + pl) * ds + s0 + sl] = sH[sl][pl];
  }
}

// (d) y of one 64-row tile of one (row, chunk), one 64-wide hp tile:
// cdec_i·(C_i·h_in) over ds steps of 64 (C^T from (a), h_in^T from (c)),
// then + sum over the causal column tiles of M·x with
// M[i][j] = G[i][j]·clip_exp(acum_i - acum_j)·dt_j where j <= i, else 0.
__global__ void __launch_bounds__(kThreads) out_kernel(const Params p) {
  __shared__ __align__(16) float smem[kPairSmemF];
  float* sA = smem;                // M^T [j][i], or C^T [s][i]
  float* sB = smem + kTileF;       // x [j][p], or h_in^T [s][p]
  float* sAj = smem + 2 * kTileF;  // acum of the column tile
  float* sDt = sAj + kT;           // dt of the column tile
  __shared__ float sAi[kT];
  const int L = p.L, hp = p.hp, ds = p.ds, nt = p.nt, tid = threadIdx.x;
  const long long rc = blockIdx.x / nt;          // row·nc + c
  const int it = nt - 1 - static_cast<int>(blockIdx.x - rc * nt);  // longest first
  const int row = static_cast<int>(rc / p.nc), c = static_cast<int>(rc % p.nc);
  const int g = row / p.bc_div;
  const int p0 = blockIdx.y * kT;
  const int i0 = it * kT, ni = min(kT, L - i0);
  const size_t t0 = static_cast<size_t>(row) * p.s + static_cast<size_t>(c) * L;
  const float* acg = p.acum + t0;
  const float* dtg = p.dt + t0;
  const float* ctg = p.ct + (static_cast<size_t>(g) * p.nc + c) * ds * L + i0;
  const float* hg = p.st + static_cast<size_t>(rc) * ds * hp + p0;
  const float* xg = p.x + t0 * hp + p0;
  const float* gtg = p.gt + (static_cast<size_t>(g) * p.nc + c) * L * L + i0;
  const int ti = tid / (kT / kTC), tj = tid % (kT / kTC);
  for (int e = tid; e < kT; e += kThreads) sAi[e] = e < ni ? acg[i0 + e] : 0.f;
  // steps k < n_ch: C·h over ds columns [k·kT, k·kT + kT) (none for chunk
  // 0, whose incoming state is zero); then M·x over column tile k - n_ch
  const int n_ch = c > 0 ? (ds + kT - 1) / kT : 0;
  float acc[kTR][kTC] = {};
  pipeline(
      n_ch + it + 1,
      [&](int k) {
        if (k < n_ch) {
          const int s0 = k * kT, ns = min(kT, ds - s0);
          load_tile(sA, ctg + static_cast<size_t>(s0) * L, L, ns, ni, p.vg);
          load_tile(sB, hg + static_cast<size_t>(s0) * hp, hp, ns, hp - p0, p.vx);
        } else {
          const int j0 = (k - n_ch) * kT, nj = min(kT, L - j0);
          load_tile(sB, xg + static_cast<size_t>(j0) * hp, hp, nj, hp - p0, p.vx);
          load_tile(sA, gtg + static_cast<size_t>(j0) * L, L, nj, ni, p.vg);
          load_row(sAj, acg + j0, nj);
          load_row(sDt, dtg + j0, nj);
        }
      },
      [&](int k) {
        if (k < n_ch) {
          mma_tile<false>(acc, sA, sB, nullptr, ti, tj, kT);
          if (k == n_ch - 1) {
#pragma unroll
            for (int r = 0; r < kTR; ++r) {
              const float cdec = clip_exp(sAi[ti * kTR + r]);
#pragma unroll
              for (int q = 0; q < kTC; ++q) acc[r][q] *= cdec;
            }
          }
          return;
        }
        const int j0 = (k - n_ch) * kT, nj = min(kT, L - j0);
        // G^T -> M^T in place; a thread's column i is the same throughout
        const int i = tid & (kT - 1);
        const float ai = sAi[i];
        const int jmax = min(nj, i < ni ? i0 + i - j0 + 1 : 0);
        for (int j = tid >> 6; j < kT; j += kThreads / kT) {
          float* m = sA + j * kTP + i;
          if (j < jmax) {
            *m = *m * clip_exp(ai - sAj[j]) * sDt[j];
          } else {
            *m = 0.f;
          }
        }
        __syncthreads();
        // on the diagonal tile, M^T[j][i] = 0 for j > i: a warp stops after
        // the last row of its threads
        mma_tile<false>(acc, sA, sB, nullptr, ti, tj,
                        j0 == i0 ? min(kT, ((tid | 31) / (kT / kTC) + 1) * kTR)
                                 : kT);
      });
  store_tile(p.y + (t0 + i0) * hp + p0, hp, ni, hp - p0, p.vx, acc, ti, tj);
}

inline unsigned cdiv(long long a, long long b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

}  // namespace

EXPORT_ERROR_STRING

// All pointers f32, contiguous, 16-byte aligned, on the current device;
// s % L == 0, bh % groups == 0 (nothing is launched when bh, s, hp or ds
// is 0). Scratch (the wrapper's torch.empty):
// acum (bh, s), gt (groups, s/L, L, L), ct (groups, s/L, ds, L),
// st (bh, s/L, ds, hp). Issues the
// four kernels on `stream`, each checked right after its launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               void* h_out, void* acum, void* gt, void* ct,
                               void* st,
                               int bh, int s, int L, int hp, int ds,
                               int groups, void* stream) {
  if (bh == 0 || s == 0 || hp == 0 || ds == 0) return 0;
  const int nc = s / L, nt = (L + kT - 1) / kT;
  Params p{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A),  static_cast<const float*>(B),
           static_cast<const float*>(C),  static_cast<float*>(y),
           static_cast<float*>(h_out),    static_cast<float*>(acum),
           static_cast<float*>(gt),       static_cast<float*>(ct),
           static_cast<float*>(st),
           bh, s, L, hp, ds, bh / groups, nc, nt,
           hp % 4 == 0, ds % 4 == 0, L % 4 == 0};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const long long rows_nc = static_cast<long long>(bh) * nc;
  const long long pairs = static_cast<long long>(nt) * (nt + 1) / 2;
  const unsigned tiles_hp = cdiv(hp, kT);
  cudaError_t err;
  cb_kernel<<<static_cast<unsigned>(groups * pairs * nc + cdiv(rows_nc, kThreads / 32)), kThreads, 0, cs>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  state_kernel<<<dim3(static_cast<unsigned>(rows_nc), cdiv(ds, kT), tiles_hp), kThreads, 0, cs>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  pass_kernel<<<dim3(bh, cdiv(ds, kPT), cdiv(hp, kPT)), kPassThreads, 0, cs>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  out_kernel<<<dim3(static_cast<unsigned>(rows_nc * nt), tiles_hp), kThreads, 0, cs>>>(p);
  return static_cast<int>(cudaGetLastError());
}
