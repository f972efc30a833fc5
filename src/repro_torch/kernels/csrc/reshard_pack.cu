// NTP reshard send-bucket gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/reshard_pack.py::reshard_pack
// (_pack_kernel), batched over the ranks of one replica:
//
//   out[r, q, :] = src[r, send_idx[r, q], :]
//
// for every rank r and send slot q (destination-major: q = dst·s_max + s).
// Index U (the zero pad row) and any index outside [0, U] write a zero row
// and read nothing. One launch writes the whole stacked send buffer
// (n, n, s_max, elems) that the all-to-all takes; the one-rank call is the
// case n_ranks = 1.
//
// Bound on this card: bytes. It is a pure copy: the valid rows it reads
// plus every row it writes. Unit rows are large (a KV-head row of
// full-size qwen2-7b is 22 MB in f32, an SSD-head row of mamba2-780m 13 MB,
// a training MLP unit 1.8-3.7 MB) and each byte is used once, so the
// design is a streaming copy:
//   * a block copies one kChunk-word piece (32 KB of 16-byte words) of one
//     output row: a 13-22 MB row is 400-700 blocks, so every call past a
//     few MB fills the 132 SMs (8 resident blocks each) and the block
//     scheduler balances the tail at 32 KB grain; 64-bit indexing, and a
//     grid-stride loop only past 2^31 - 1 pieces;
//   * each thread issues kUnroll independent loads before its stores
//     (kUnroll · 16 bytes in flight per thread), at in-row offsets
//     threadIdx.x + k·kThreads, so a warp's accesses are contiguous;
//   * streaming cache hints (ld.global.cs / st.global.cs): rows are read
//     and written once and are larger than the 50 MB L2;
//   * pad slots store zeros without loading;
//   * words are 16 bytes when the rows and both pointers are 16-byte
//     aligned (unit rows are multiples of 128 elements), narrower only when
//     something is not.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kChunk = static_cast<long long>(kThreads) * kUnroll;
constexpr long long kMaxGrid = 0x7fffffff;

template <typename W>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const W* __restrict__ src, const int32_t* __restrict__ idx,
                W* __restrict__ out, int up1, long long slots_per_rank,
                long long n_slots, long long words, long long chunks) {
  const long long items = n_slots * chunks;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long slot = item / chunks;
    const long long off = (item - slot * chunks) * kChunk + threadIdx.x;
    const long long left = words - off;  // row words from its first word on
    W* dst = out + slot * words + off;
    const int u = idx[slot];
    if (u >= 0 && u < up1 - 1) {
      const long long rank = slot / slots_per_rank;
      const W* s = src + (rank * up1 + u) * words + off;
      W v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (k * kThreads < left) v[k] = __ldcs(s + k * kThreads);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (k * kThreads < left) __stcs(dst + k * kThreads, v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (k * kThreads < left) __stcs(dst + k * kThreads, W{});
    }
  }
}

template <typename W>
int launch(const void* src, const int32_t* idx, void* out, int up1,
           long long slots_per_rank, long long n_slots, long long row_bytes,
           cudaStream_t s) {
  const long long words = row_bytes / static_cast<long long>(sizeof(W));
  const long long chunks = (words + kChunk - 1) / kChunk;
  long long grid = n_slots * chunks;
  if (grid > kMaxGrid) grid = kMaxGrid;
  pack_kernel<W><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const W*>(src), idx, static_cast<W*>(out), up1,
      slots_per_rank, n_slots, words, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

EXPORT_ERROR_STRING

// src: (n_ranks, up1, row_bytes) bytes, the last row of each rank the zero
// pad; idx: (n_ranks, slots_per_rank) int32; out: (n_ranks,
// slots_per_rank, row_bytes) bytes. The word width follows the alignment of
// the rows and both pointers.
extern "C" int reshard_pack_launch(const void* src, const void* idx,
                                   void* out, int n_ranks, int up1,
                                   long long slots_per_rank,
                                   long long row_bytes, void* stream) {
  const long long n_slots = n_ranks * slots_per_rank;
  if (n_slots == 0 || row_bytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const int32_t*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(src, ix, out, up1, slots_per_rank, n_slots, row_bytes, s);
  if (align % 8 == 0)
    return launch<uint2>(src, ix, out, up1, slots_per_rank, n_slots, row_bytes, s);
  if (align % 4 == 0)
    return launch<unsigned int>(src, ix, out, up1, slots_per_rank, n_slots, row_bytes, s);
  if (align % 2 == 0)
    return launch<unsigned short>(src, ix, out, up1, slots_per_rank, n_slots, row_bytes, s);
  return launch<unsigned char>(src, ix, out, up1, slots_per_rank, n_slots, row_bytes, s);
}
