// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): row-wise y = x * rsqrt(mean(x^2) + eps) * w, or
// * (1 + w) when plus_one, computed in f32 and stored in x's type.
//
// Bound on this card: bytes. Each row is read once and written once:
// 2·N·d·sizeof(T) + d·sizeof(T) bytes against ~4 flops per element. On the
// decode paths (1-32 rows) that is well under a microsecond at 3.35 TB/s,
// so the host's cost of a call sets the time (see kernels/build.py); at the
// Mamba-2 prefill (8192 rows) the design must stream at the memory rate.
//
// Design: one pass over device memory. A row is split over a group of TPR
// threads (a power of two from 32 to 1024, chosen by the wrapper so that
// each thread holds at most kMaxWords words), and thread t holds the words
// t, t + TPR, t + 2·TPR, ... of the row in registers (neighbouring threads
// on neighbouring addresses). A word is 16 bytes (4 f32 or 8 bf16) when
// d is a multiple of that and every pointer is 16-byte aligned, else one
// element (the scalar path, same code). Each thread sums its squares in
// word order, the group reduces them with xor shuffles (every lane ends
// with the same bits) and, past one warp, across its warps through shared
// memory in warp order; the scale pass then reuses the registers. Groups
// narrower than 128 threads share a block (128/TPR rows per block). The
// grid holds as many row groups as the card keeps resident, each walking
// its rows with the next row's loads issued before the current row's
// reduction (at 8192 rows the reduction and scale would otherwise leave
// the memory idle between rows); x is loaded and y stored with streaming
// cache hints (ld/st.global.cs), as each is touched once. A row too wide for registers (more than
// 1024·kMaxWords words) takes the loop path: one 1024-thread block per
// row that reads the row twice.
#include "common.cuh"

namespace {

constexpr int kMaxWords = 4;    // words a thread keeps in registers
constexpr int kLoopThreads = 1024;

template <typename T>
__device__ __forceinline__ float weight(T w, int plus_one) {
  const float v = to_f32(w);
  return plus_one ? 1.f + v : v;
}

// Sum of squares of the elements of one word, in element order.
template <typename T, typename W>
__device__ __forceinline__ float word_ss(const W& v, float ss) {
  constexpr int kVec = sizeof(W) / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const float f = to_f32(e[k]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

template <typename T, typename W>
__device__ __forceinline__ W word_scale(const W& v, const W& wv, float r,
                                        int plus_one) {
  constexpr int kVec = sizeof(W) / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  const T* we = reinterpret_cast<const T*>(&wv);
  W out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    o[k] = from_f32<T>(to_f32(e[k]) * r * weight(we[k], plus_one));
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads row `row`'s words t, t + TPR, ... into v (none past the row or
// past n), with the streaming hint: x is read once.
template <typename W, int TPR>
__device__ __forceinline__ void load_row(W (&v)[kMaxWords], const W* x,
                                         long long row, int n, int nw,
                                         int t) {
  if (row >= n) return;
  const W* xr = x + row * nw;
#pragma unroll
  for (int i = 0; i < kMaxWords; ++i)
    if (t + i * TPR < nw) v[i] = __ldcs(xr + t + i * TPR);
}

// Register path. Block (TPR, R): threadIdx.y picks one of R rows. Each row
// group walks rows row, row + stride, ... and loads its next row before it
// reduces and scales the current one, so the next loads are in flight
// while it computes.
template <typename T, typename W, int TPR>
__global__ void __launch_bounds__(TPR >= 128 ? TPR : 128)
    rmsnorm_regs(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int n, int d, float eps, int plus_one) {
  constexpr int kVec = sizeof(W) / sizeof(T);
  constexpr int kRows = TPR >= 128 ? 1 : 128 / TPR;
  constexpr int kWarps = TPR / 32;
  const int nw = d / kVec;                       // words per row
  const int t = threadIdx.x;
  const W* xw = reinterpret_cast<const W*>(x);
  const W* ww = reinterpret_cast<const W*>(w);
  W* yw = reinterpret_cast<W*>(y);
  const long long stride = static_cast<long long>(gridDim.x) * kRows;
  __shared__ float part[2][kRows][kWarps];
  W cur[kMaxWords], nxt[kMaxWords];
  load_row<W, TPR>(cur, xw, static_cast<long long>(blockIdx.x) * kRows +
                   threadIdx.y, n, nw, t);
  int parity = 0;
  // the loop runs on block bases so that every thread reaches each barrier
  for (long long base = static_cast<long long>(blockIdx.x) * kRows; base < n;
       base += stride, parity ^= 1) {
    const long long row = base + threadIdx.y;
    load_row<W, TPR>(nxt, xw, row + stride, n, nw, t);
    float ss = 0.f;
    if (row < n) {
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i)
        if (t + i * TPR < nw) ss = word_ss<T>(cur[i], ss);
    }
    ss = warp_sum(ss);
    if constexpr (kWarps > 1) {
      // two buffers: a warp may start the next row's sum while another
      // still reads this one's
      if ((t & 31) == 0) part[parity][threadIdx.y][t >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) ss += part[parity][threadIdx.y][i];
    }
    if (row < n) {
      const float r = rsqrtf(ss / static_cast<float>(d) + eps);
      W* yr = yw + row * nw;
#pragma unroll
      for (int i = 0; i < kMaxWords; ++i) {
        const int j = t + i * TPR;
        if (j < nw) __stcs(yr + j, word_scale<T>(cur[i], ww[j], r, plus_one));
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxWords; ++i) cur[i] = nxt[i];
  }
}

// Loop path: one kLoopThreads block per row, the row read twice.
template <typename T, typename W>
__global__ void __launch_bounds__(kLoopThreads)
    rmsnorm_loop(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int d, float eps, int plus_one) {
  constexpr int kVec = sizeof(W) / sizeof(T);
  constexpr int kWarps = kLoopThreads / 32;
  const int nw = d / kVec;
  const W* xr = reinterpret_cast<const W*>(
      x + static_cast<long long>(blockIdx.x) * d);
  float ss = 0.f;
  for (int j = threadIdx.x; j < nw; j += kLoopThreads)
    ss = word_ss<T>(xr[j], ss);
  ss = warp_sum(ss);
  __shared__ float part[kWarps];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) ss += part[i];
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const W* wr = reinterpret_cast<const W*>(w);
  W* yr = reinterpret_cast<W*>(y + static_cast<long long>(blockIdx.x) * d);
  for (int j = threadIdx.x; j < nw; j += kLoopThreads)
    yr[j] = word_scale<T>(xr[j], wr[j], r, plus_one);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Grid of the register path: enough row groups to fill every SM at the
// kernel's occupancy, each walking the same number of rows (the last few
// one fewer), so no SM idles on a ragged last wave.
template <typename T, typename W, int TPR>
void launch_regs(const void* x, const void* w, void* y, int n, int d,
                 float eps, int plus_one, cudaStream_t s) {
  constexpr int kRows = TPR >= 128 ? 1 : 128 / TPR;
  static int resident = 0;  // blocks the whole card holds at once
  if (resident == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, rmsnorm_regs<T, W, TPR>, TPR * kRows, 0);
    resident = (resident > 0 ? resident : 1) * sm_count();
  }
  const long long groups = (static_cast<long long>(n) + kRows - 1) / kRows;
  const long long rounds = (groups + resident - 1) / resident;
  const unsigned blocks = static_cast<unsigned>((groups + rounds - 1) / rounds);
  rmsnorm_regs<T, W, TPR><<<blocks, dim3(TPR, kRows), 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      n, d, eps, plus_one);
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int n, int d, float eps,
           int plus_one, int tpr, int words_per_thread, cudaStream_t s) {
  if (words_per_thread == 0) {
    rmsnorm_loop<T, W><<<n, kLoopThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), d, eps, plus_one);
    return 0;
  }
  if (words_per_thread > kMaxWords ||
      static_cast<long long>(tpr) * words_per_thread <
          d / static_cast<int>(sizeof(W) / sizeof(T)))
    return cudaErrorInvalidValue;
  switch (tpr) {
    case 32: launch_regs<T, W, 32>(x, w, y, n, d, eps, plus_one, s); break;
    case 64: launch_regs<T, W, 64>(x, w, y, n, d, eps, plus_one, s); break;
    case 128: launch_regs<T, W, 128>(x, w, y, n, d, eps, plus_one, s); break;
    case 256: launch_regs<T, W, 256>(x, w, y, n, d, eps, plus_one, s); break;
    case 512: launch_regs<T, W, 512>(x, w, y, n, d, eps, plus_one, s); break;
    case 1024: launch_regs<T, W, 1024>(x, w, y, n, d, eps, plus_one, s); break;
    default: return cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int n, int d, float eps,
             int plus_one, int vec, int tpr, int words_per_thread,
             cudaStream_t s) {
  if (vec == 1)
    return launch<T, T>(x, w, y, n, d, eps, plus_one, tpr, words_per_thread, s);
  if (vec * static_cast<int>(sizeof(T)) != 16 || d % vec != 0)
    return cudaErrorInvalidValue;
  return launch<T, uint4>(x, w, y, n, d, eps, plus_one, tpr, words_per_thread, s);
}

}  // namespace

EXPORT_ERROR_STRING

// What the wrapper fixes once per (d, dtype, plus_one, eps, alignment) and
// passes by pointer (kernels/rmsnorm.py::Params, same layout): fewer
// arguments to convert on every call. (vec, tpr, words_per_thread) come
// from the wrapper's launch_config: elements per word (1, or 16 bytes'
// worth when every pointer is 16-byte aligned and vec divides d), threads
// per row, and words each thread keeps in registers (0: the loop path).
struct Params {
  int d;
  float eps;
  int plus_one;
  int dtype;
  int vec;
  int tpr;
  int words_per_thread;
};

// x, y: (n, d) row-major; w: (d,). All pointers on the current device.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int n,
                              const Params* p, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (p->dtype == kF32) {
    err = dispatch<float>(x, w, y, n, p->d, p->eps, p->plus_one, p->vec,
                          p->tpr, p->words_per_thread, s);
  } else if (p->dtype == kBF16) {
    err = dispatch<__nv_bfloat16>(x, w, y, n, p->d, p->eps, p->plus_one,
                                  p->vec, p->tpr, p->words_per_thread, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
