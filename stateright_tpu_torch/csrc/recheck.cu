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
// Bound: bytes.  The chunk's n * P cond bytes are read once and P 8-byte
// slots written; the logic is a few operations a byte.
// Design: a grid-stride loop of a few blocks an SM over the n * P bytes
// as one flat array, 16 bytes a load (the unaligned head and the tail a
// byte at a time).  A thread's bytes come in increasing position, so its
// first hit of a property is its minimum: it keeps a register mask of the
// properties it has hit and posts only that first hit to the block's
// shared minimum (a shared atomicMin).  At the end one 64-bit atomicMin
// a block a property folds the block minima into the slots: at most
// blocks * P global atomics where one a warp and property serialized
// before, and the minimum does not depend on the order blocks run in.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kNone = 0xFFFFFFFFu;

struct Scan {
  int p;
  uint32_t always, sometimes;
  int64_t start;

  // Byte q of row s: post row s to property q's block minimum if it is
  // the thread's first hit of q.
  __device__ __forceinline__ void visit(uint8_t c, int64_t s, int q,
                                        uint32_t& found,
                                        uint32_t* smin) const {
    const uint32_t bit = 1u << q;
    const bool hit = c ? (sometimes & bit) != 0 : (always & bit) != 0;
    if (hit && !(found & bit)) {
      found |= bit;
      atomicMin(smin + q, static_cast<uint32_t>(start + s));
    }
  }
};

__global__ void __launch_bounds__(kThreads) first_hits_kernel(
    const uint8_t* __restrict__ conds, int64_t n, Scan scan,
    unsigned long long* __restrict__ slots) {
  __shared__ uint32_t smin[32];
  if (threadIdx.x < 32) smin[threadIdx.x] = kNone;
  __syncthreads();
  const int p = scan.p;
  const int64_t total = n * p;
  const int64_t head_len = static_cast<int64_t>(
      (16 - (reinterpret_cast<uintptr_t>(conds) & 15)) & 15);
  const int64_t head = head_len < total ? head_len : total;
  const int64_t vecs = (total - head) / 16;
  const int64_t tail = head + vecs * 16;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  uint32_t found = 0;
  // The unaligned head, the 16-byte body, the tail: each in increasing
  // position, and every head byte before every body byte before every
  // tail byte.
  if (tid < head) scan.visit(conds[tid], tid / p, static_cast<int>(tid % p), found, smin);
  const uint4* body = reinterpret_cast<const uint4*>(conds + head);
  for (int64_t v = tid; v < vecs; v += stride) {
    const uint4 w = body[v];
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
    const int64_t f = head + v * 16;
    int64_t s = f / p;
    int q = static_cast<int>(f - s * p);
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      scan.visit(static_cast<uint8_t>(words[b >> 2] >> (8 * (b & 3))), s, q,
                 found, smin);
      if (++q == p) {
        q = 0;
        ++s;
      }
    }
  }
  const int64_t t = tail + tid;
  if (t < total) scan.visit(conds[t], t / p, static_cast<int>(t % p), found, smin);
  __syncthreads();
  if (threadIdx.x < p && smin[threadIdx.x] != kNone)
    atomicMin(slots + threadIdx.x, static_cast<unsigned long long>(smin[threadIdx.x]));
}

}  // namespace

// conds: n * p bytes; slots: p u64 words, NO_ID where no hit yet.
extern "C" int sr_first_hits(const uint8_t* conds, int64_t n, int p,
                             uint32_t always, uint32_t sometimes,
                             int64_t start, unsigned long long* slots,
                             cudaStream_t stream) {
  if (n <= 0 || p <= 0) return 0;
  const int64_t total = n * p;
  int64_t blocks = (total / 16 + kThreads - 1) / kThreads;
  if (blocks > 132 * kBlocksPerSm) blocks = 132 * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  first_hits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      conds, n, Scan{p, always, sometimes, start}, slots);
  return static_cast<int>(cudaGetLastError());
}
