// Gradient-bucket pack / unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/bucket.py::_pack_kernel
// (bucket_pack) and ::_unpack_kernel (bucket_unpack):
//
//   pack:   leaves (rows, w_0), ..., (rows, w_{k-1})  ->  flat (rows, Σw_i),
//           leaf i landing in columns [off_i, off_i + w_i)
//   unpack: the exact inverse (same static offsets, read instead of written).
//
// Bound on this card: bytes. Both are pure copies: every element is read
// once and written once, 2·rows·Σw·itemsize bytes at 3.35 TB/s. On the
// overlapped gradient sync a bucket holds every unit leaf of one chunk of
// layers stacked over all emulated (replica, rank) buffers: the MLP bucket of
// one qwen2-7b layer is 296-400 rows of 917,504 f32 columns (1.1-1.5 GB), so
// the design is a streaming copy:
//   * ONE launch covers every leaf: blockIdx.z picks the leaf, blockIdx.y
//     the row (grid-strided past 65,535 rows), blockIdx.x a tile of
//     kThreads·kUnroll words of that (leaf, row) segment. No division or
//     modulo per element; each thread loads kUnroll words before storing.
//   * The leaf table (pointer, width, column offset per leaf) travels BY
//     VALUE as a kernel parameter (<4 KB for kMaxLeaves leaves): no device
//     allocation and no host-to-device copy per call, although pointers
//     change on every call.
//   * Words are 16 bytes when every pointer, width, offset and the row
//     pitch are 16-byte multiples (every width on the path is a multiple of
//     128 elements); narrower words only where something is unaligned.
//   * 64-bit index arithmetic throughout: at full 28-layer depth one bucket
//     is ~2.6 G elements, past 2^31.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll;
constexpr int kMaxLeaves = 128;
constexpr int kMaxGridY = 65535;

struct Table {
  void* ptr[kMaxLeaves];
  long long words[kMaxLeaves];  // leaf width in words
  long long off[kMaxLeaves];    // column offset in the flat, in words
};

// kPack: leaf -> flat; else flat -> leaf.
template <typename W, bool kPack>
__global__ void __launch_bounds__(kThreads)
    bucket_kernel(const Table t, W* __restrict__ flat, long long rows,
                  long long total_words) {
  const int leaf = blockIdx.z;
  const long long w = t.words[leaf];
  W* leaf_base = static_cast<W*>(t.ptr[leaf]);
  const long long off = t.off[leaf];
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    W* f = flat + row * total_words + off;
    W* l = leaf_base + row * w;
    const W* src = kPack ? l : f;
    W* dst = kPack ? f : l;
    for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < w;
         base += stride) {
      W v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads + threadIdx.x;
        if (i < w) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads + threadIdx.x;
        if (i < w) dst[i] = v[u];
      }
    }
  }
}

template <typename W>
int launch(bool pack, void* const* ptrs, const long long* width_bytes, int n,
           void* flat, long long rows, long long total_bytes,
           cudaStream_t s) {
  constexpr long long kW = static_cast<long long>(sizeof(W));
  Table t;
  long long off = 0, max_words = 0;
  for (int i = 0; i < n; ++i) {
    t.ptr[i] = ptrs[i];
    t.words[i] = width_bytes[i] / kW;
    t.off[i] = off;
    off += t.words[i];
    if (t.words[i] > max_words) max_words = t.words[i];
  }
  if (max_words == 0) return 0;
  long long bx = (max_words + kTile - 1) / kTile;
  if (bx > 0x7fffffffLL) bx = 0x7fffffffLL;
  const unsigned by = static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY);
  const dim3 grid(static_cast<unsigned>(bx), by, static_cast<unsigned>(n));
  if (pack) {
    bucket_kernel<W, true><<<grid, kThreads, 0, s>>>(
        t, static_cast<W*>(flat), rows, total_bytes / kW);
  } else {
    bucket_kernel<W, false><<<grid, kThreads, 0, s>>>(
        t, static_cast<W*>(flat), rows, total_bytes / kW);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT_ERROR_STRING

extern "C" int bucket_max_leaves() { return kMaxLeaves; }

// pack != 0: copy leaves[i] (rows, width_bytes[i]) into flat's column range
// [Σ_{j<i} width_bytes[j], ...) of each (rows, total_bytes) row; pack == 0:
// the inverse. n <= kMaxLeaves; Σ width_bytes <= total_bytes (the wrapper
// passes the leaves of one flat, possibly a group of them, with the group's
// first column already folded into `flat`). The word width follows the
// alignment of every pointer, width and the row pitch.
extern "C" int bucket_copy_launch(int pack, void* const* ptrs,
                                  const long long* width_bytes, int n,
                                  void* flat, long long rows,
                                  long long total_bytes, void* stream) {
  if (n <= 0 || n > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uintptr_t align = reinterpret_cast<uintptr_t>(flat) |
                    static_cast<uintptr_t>(total_bytes);
  for (int i = 0; i < n; ++i) {
    align |= reinterpret_cast<uintptr_t>(ptrs[i]) |
             static_cast<uintptr_t>(width_bytes[i]);
  }
  const bool p = pack != 0;
  if (align % 16 == 0) return launch<uint4>(p, ptrs, width_bytes, n, flat, rows, total_bytes, s);
  if (align % 8 == 0) return launch<uint2>(p, ptrs, width_bytes, n, flat, rows, total_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(p, ptrs, width_bytes, n, flat, rows, total_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(p, ptrs, width_bytes, n, flat, rows, total_bytes, s);
  return launch<uint8_t>(p, ptrs, width_bytes, n, flat, rows, total_bytes, s);
}
