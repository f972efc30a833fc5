// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): row-wise y = x * rsqrt(mean(x^2) + eps) * w, or
// * (1 + w) when plus_one, computed in f32 and stored in x's type.
//
// Bound on this card: bytes. Each row is read, reduced and written once:
// 2·N·d·sizeof(T) + d·sizeof(T) bytes against ~4 flops per element. On the
// serving path (N = 8 decode rows or 32 prefill rows, d = 3584, f32) that is
// ~0.2-0.9 MB, well under a microsecond at 3.35 TB/s, so a launch costs
// more than the data: the design keeps one launch per norm and nothing
// else. One block per row; each thread strides the row (coalesced), the
// sum of squares is reduced with warp shuffles and then across the
// block's warps through shared memory, and the second pass re-reads the
// row (from L1/L2) to scale it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int d, float eps, int plus_one) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float partial[kWarps];
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kWarps; ++i) total += partial[i];  // same order everywhere
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    float wv = to_f32(w[i]);
    if (plus_one) wv = 1.f + wv;
    yr[i] = from_f32<T>(to_f32(xr[i]) * r * wv);
  }
}

}  // namespace

EXPORT_ERROR_STRING

// x, y: (n, d) row-major; w: (d,). All pointers on the current device.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int n,
                              int d, float eps, int plus_one, int dtype,
                              void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    rmsnorm_kernel<float><<<n, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps, plus_one);
  } else if (dtype == kBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        d, eps, plus_one);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
