// K5: Deliver-lane validity of packed paxos rows, without successors.
//
// Replaces stateright_tpu/models/paxos_compiled.py:549 step_valid, with
// register_compiled_common.py:38 representative_slot_code inlined: lane k
// of a state is valid iff slot k holds the first code of its run and the
// destination's guard for that message tag holds.  Phase A of two-phase
// expansion: about one lane in twenty survives, and only those get a
// successor built (K7).
//
// Bound: bytes.  Each state's row is read (the slot section, the three
// server records and the client word: 4 * (7 + M) bytes) and one validity
// byte a lane written; the guard is a few dozen integer operations.
// Design: one thread per (state, slot) lane, so a warp covers one state's
// 32 slots at C = 3 (two states' 16 at C <= 2, half a state's 64 from
// C = 4): slot reads are coalesced,
// the server and client words are the same address across the warp and
// served from L1, and the validity bytes are written contiguously.  The
// destination's record is chosen by a select over the three loaded
// records, not a gather.
#include "paxos_common.cuh"

namespace {

template <int C>
__global__ void paxos_valid_kernel(const uint32_t* __restrict__ states,
                                   int64_t f, uint8_t* __restrict__ valid) {
  using G = paxos::Geom<C>;
  const int64_t lanes = f * G::M;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < lanes; t += stride) {
    const int64_t s = t / G::M;
    const int k = static_cast<int>(t - s * G::M);
    const uint32_t* row = states + s * G::W;
    const uint32_t code = row[paxos::NET0 + k];
    const uint32_t prev = k == 0 ? 0u : row[paxos::NET0 + k - 1];
    uint32_t srv[2 * paxos::S];
#pragma unroll
    for (int i = 0; i < 2 * paxos::S; ++i) srv[i] = row[i];
    const paxos::Lane l = paxos::decode_lane(code, srv);
    valid[t] = paxos::occupied(code, prev, k) &&
                       paxos::guard<C>(l, row[paxos::CLI])
                   ? 1
                   : 0;
  }
}

}  // namespace

// states: f rows of Geom<c>::W words; valid: f * Geom<c>::M bytes.
extern "C" int sr_paxos_step_valid(const uint32_t* states, int64_t f, int c,
                                   uint8_t* valid, cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
#define LAUNCH(C)                                                        \
  paxos_valid_kernel<C><<<sr::grid_for(f * paxos::Geom<C>::M, kThreads), \
                          kThreads, 0, stream>>>(states, f, valid)
  PAXOS_DISPATCH(c, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
