// K22: the first hit of each property over a chunk of stored rows.
//
// Replaces stateright_tpu/incr/recheck.py:121 _property_recheck's scan
// (:153 eval_chunk's vmap(property_conds) result, then per property the
// lowest triggering position, :166-186): given a chunk's conditions
// conds[n, P] (one byte each, from the model's own conds kernel), the
// ALWAYS and SOMETIMES masks over the P properties and the chunk's first BFS
// position `start`, write for each property p the lowest position start + s
// whose cond fails (ALWAYS) or holds (SOMETIMES).  Properties in neither
// mask (EVENTUALLY, or already found) are never hit.  The caller sets
// slots[] to NO_ID (0xFFFFFFFF) first; a property with no hit keeps it.
//
// The first hit is a warp minimum followed by a 64-bit atomicMin on the
// position, as K8's first_hit (wave_eval.cu), so the result does not depend
// on the order the blocks run in.
//
// Bound: bytes.  Each state's P cond bytes are read once and P 8-byte slots
// written; the logic is a few operations a byte.  Design: one thread per
// state, no grid-stride loop, so every lane of a warp reaches the warp
// minimum (those past n with no hit).
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void first_hits_kernel(const uint8_t* __restrict__ conds,
                                  int64_t n, int p, uint32_t always,
                                  uint32_t sometimes, int64_t start,
                                  unsigned long long* __restrict__ slots) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = s < n;
  const uint32_t pos = static_cast<uint32_t>(start + s);
  for (int q = 0; q < p; ++q) {
    const uint32_t bit = 1u << q;
    bool hit = false;
    if (live) {
      const bool c = conds[s * p + q] != 0;
      hit = ((always & bit) && !c) || ((sometimes & bit) && c);
    }
    const uint32_t m = __reduce_min_sync(0xFFFFFFFFu, hit ? pos : 0xFFFFFFFFu);
    if ((threadIdx.x & 31) == 0 && m != 0xFFFFFFFFu)
      atomicMin(slots + q, static_cast<unsigned long long>(m));
  }
}

}  // namespace

// conds: n * p bytes; slots: p u64 words, NO_ID where no hit yet.
extern "C" int sr_first_hits(const uint8_t* conds, int64_t n, int p,
                             uint32_t always, uint32_t sometimes,
                             int64_t start, unsigned long long* slots,
                             cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  first_hits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      conds, n, p, always, sometimes, start, slots);
  return static_cast<int>(cudaGetLastError());
}
