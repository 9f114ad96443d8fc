// K1: 64-bit fingerprints of packed state rows.
//
// Replaces stateright_tpu/ops/device_fp.py:52 device_fp64 (with _mix32 :33,
// _fmix32 :43 and _remap_pair :72) and is bit-identical to it and to the host
// fp64_words: two murmur3-style u32 lanes seeded SEED_HI/SEED_LO, finalised
// with the word count, then (0,0) -> (0,1) and all-ones -> ...FFFE.
//
// A row is the first w words at words + i * row_stride: a model whose state
// identity is a row's leading fp_words words (raft: 55 of 58) has that
// prefix hashed in place, as the JAX engine hashes rows[:, :fp_words].
//
// Bound: bytes.  A row of W words is read once and two words are written;
// the ~20 integer operations per word are far below the card's integer rate,
// so the kernel is limited by device-memory traffic (4W + 8 bytes a row).
// Design: one thread per row in a grid-stride loop, so neighbouring threads
// read neighbouring rows (a warp covers 32*4*row_stride contiguous bytes) and
// write neighbouring words of the two output planes; no shared memory
// needed.
//
// The counted entry (sr_device_fp64_n) hashes only the first *count rows,
// the count read on the card (K3's count of a two-phase wave's valid
// lanes), so the fused wave loop (K29) hashes the n_valid successors it
// built, not the whole compaction buffer, with no host read; rows past the
// count are left unwritten.
#include "sr_common.cuh"

namespace {

__global__ void fp64_kernel(const uint32_t* __restrict__ words, int64_t n,
                            int w, int64_t row_stride,
                            uint32_t* __restrict__ hi,
                            uint32_t* __restrict__ lo,
                            const int64_t* __restrict__ count) {
  if (count != nullptr && *count < n) n = *count;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t* row = words + i * row_stride;
    uint32_t h1 = sr::SEED_HI;
    uint32_t h2 = sr::SEED_LO;
    for (int k = 0; k < w; ++k) {
      const uint32_t x = row[k];
      h1 = sr::mix32(h1, x);
      h2 = sr::mix32(h2, x);
    }
    h1 = sr::fmix32(h1 ^ static_cast<uint32_t>(w));
    h2 = sr::fmix32(h2 ^ (static_cast<uint32_t>(w) * 0x9E3779B1u));
    if (h1 == 0u && h2 == 0u) h2 = 1u;
    if (h1 == 0xFFFFFFFFu && h2 == 0xFFFFFFFFu) h2 = 0xFFFFFFFEu;
    hi[i] = h1;
    lo[i] = h2;
  }
}

}  // namespace

// Row i is the w words at words + i * row_stride (row_stride >= w).
extern "C" int sr_device_fp64(const uint32_t* words, int64_t n, int w,
                              int64_t row_stride, uint32_t* hi, uint32_t* lo,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  fp64_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      words, n, w, row_stride, hi, lo, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The counted entry: rows [0, min(n, *count)) of the n-row buffer.
extern "C" int sr_device_fp64_n(const uint32_t* words, int64_t n, int w,
                                int64_t row_stride, const int64_t* count,
                                uint32_t* hi, uint32_t* lo,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  fp64_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      words, n, w, row_stride, hi, lo, count);
  return static_cast<int>(cudaGetLastError());
}
