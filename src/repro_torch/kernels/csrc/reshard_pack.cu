// NTP reshard send-bucket gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/reshard_pack.py::reshard_pack
// (_pack_kernel): out[i, s, :] = src[send_idx[i, s], :], one unit row per
// (destination, message slot); index U selects the zero pad row. An index
// outside [0, U] writes a zero row instead of reading out of bounds.
//
// Bound on this card: bytes. It is a pure copy: the rows it reads plus the
// n·s_max rows it writes. On the serving path a KV-head unit row is
// 2·L·slots·T·hd elements (22 MB in f32 for full-size qwen2-7b), so the
// design is a streaming copy: each (destination, slot) row is split over
// many blocks, every thread moves 16-byte words (unit rows are multiples of
// 128 elements, so rows of any element type are 16-byte multiples), and
// the loop over the row is grid-strided. Narrower words are used only when
// a row or pointer is not 16-byte aligned.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 1024;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const W* __restrict__ src, const int32_t* __restrict__ idx,
                W* __restrict__ out, int up1, int n_slots, long long words) {
  for (int slot = blockIdx.y; slot < n_slots; slot += gridDim.y) {
    const int u = idx[slot];
    const bool valid = u >= 0 && u < up1;
    const W* row = src + static_cast<long long>(valid ? u : 0) * words;
    W* dst = out + static_cast<long long>(slot) * words;
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         i < words; i += stride) {
      dst[i] = valid ? row[i] : W{};
    }
  }
}

template <typename W>
int launch(const void* src, const int32_t* idx, void* out, int up1,
           int n_slots, long long row_bytes, cudaStream_t s) {
  const long long words = row_bytes / static_cast<long long>(sizeof(W));
  long long bx = (words + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  if (bx < 1) bx = 1;
  const int by = n_slots < 65535 ? n_slots : 65535;
  pack_kernel<W><<<dim3(static_cast<unsigned>(bx), by), kThreads, 0, s>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out), up1, n_slots,
      words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT_ERROR_STRING

// src: (up1, row_bytes) bytes; idx: (n_slots,) int32; out: (n_slots,
// row_bytes) bytes. The word width follows the alignment of rows and
// pointers.
extern "C" int reshard_pack_launch(const void* src, const void* idx,
                                   void* out, int up1, int n_slots,
                                   long long row_bytes, void* stream) {
  if (n_slots == 0 || row_bytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(src, ix, out, up1, n_slots, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(src, ix, out, up1, n_slots, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(src, ix, out, up1, n_slots, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(src, ix, out, up1, n_slots, row_bytes, s);
  return launch<uint8_t>(src, ix, out, up1, n_slots, row_bytes, s);
}
