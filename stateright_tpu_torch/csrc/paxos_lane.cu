// K7: the successor of each compacted valid paxos lane (phase B).
//
// Replaces stateright_tpu/models/paxos_compiled.py:625 step_lane / :638
// _deliver_lane and the parent-row gather of the two-phase wave
// (stateright_tpu/parallel/wavefront.py:637-645): for buffer lane j < n,
// v = v_orig[j] names state v / M of the wave and slot k = v % M; the
// kernel reads that parent row itself, runs the destination's handler (the
// 9-way message dispatch of PaxosActor / RegisterClient over the packed
// record), removes the delivered envelope from the slots, inserts up to
// three sends, and writes the successor row and its flag: a send past the
// M slots, or a branch the packed layout cannot hold (a round past 15, a
// Get on an undecided value, a missing proposal).  n is K3's device count
// of valid lanes (clamped to the buffer), read here, so no host sync
// separates the compaction from this launch.
//
// Bound: bytes.  Each of the n lanes reads its index (4 bytes) and its
// parent row (4W) and writes its successor (4W) and a flag byte; the
// handler and the slot merge are a few hundred integer operations a lane.
// Design: one thread per compacted lane, for C = 1..7 (M = 16, 32 or 64
// slots; the server-record fields after the proposal move with its width,
// paxos_common.cuh).  Every field the handler touches is loaded into
// registers with static indices; the lane itself is paxos_deliver.cuh's,
// which K14 shares.  Rows past n are not written and their flags are 0.
#include "paxos_deliver.cuh"

namespace {

template <int C>
__global__ void paxos_lane_kernel(const uint32_t* __restrict__ states,
                                  int64_t f,
                                  const uint32_t* __restrict__ v_orig,
                                  int64_t u, const int64_t* __restrict__ count,
                                  uint32_t* __restrict__ nexts,
                                  uint8_t* __restrict__ flags) {
  using G = paxos::Geom<C>;
  const int64_t n = *count < u ? *count : u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < u; j += stride) {
    if (j >= n) {
      flags[j] = 0;
      continue;
    }
    const uint32_t v = v_orig[j];
    const int64_t src = v / G::M;
    const int k = static_cast<int>(v % G::M);
    const uint32_t* row = states + (src < f ? src : 0) * G::W;
    bool valid;
    flags[j] = paxos::deliver_lane<C>(row, k, nexts + j * G::W, valid) ? 1 : 0;
  }
}

}  // namespace

// states: f rows of Geom<c>::W words (the wave); v_orig: u lane indices;
// count: one int64 (lanes of v_orig that are real, may exceed u);
// nexts: u rows of W words; flags: u bytes.
extern "C" int sr_paxos_step_lane(const uint32_t* states, int64_t f, int c,
                                  const uint32_t* v_orig, int64_t u,
                                  const int64_t* count, uint32_t* nexts,
                                  uint8_t* flags, cudaStream_t stream) {
  if (u <= 0) return 0;
  constexpr int kThreads = 128;
#define LAUNCH(C)                                                   \
  paxos_lane_kernel<C><<<sr::grid_for(u, kThreads), kThreads, 0,    \
                         stream>>>(states, f, v_orig, u, count, nexts, flags)
  PAXOS_DISPATCH(c, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
