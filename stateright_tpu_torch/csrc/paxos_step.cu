// K14: the single-phase paxos step of a ballot-bounded model.
//
// Replaces stateright_tpu/models/paxos_compiled.py:541 step (every lane's
// _deliver_lane) and :135 boundary (every server's ballot round at most
// max_round), with the engine's valid &= boundary(nexts) of
// stateright_tpu/parallel/wave_common.py:358-359.  A model bounded below
// the encoding's round cap cannot screen validity before it builds
// successors -- the boundary tests the successor -- so the engine expands
// it in one phase: every (state, slot) lane's successor row, its validity
// ANDed with the successor's boundary test, and its flag, which the
// wrapper reduces to each state's and the wave's encoding-overflow flag
// (the flag is the JAX step's, taken before the boundary).  The device
// walk (parallel/simulation_gpu.py) runs the JAX step with no boundary:
// its wrapper passes max_round = 0xFFFFFFFF, which every round passes.
//
// Bound: bytes.  Each lane writes its W-word successor, a valid byte and a
// flag byte; the parent row (4W bytes) is read from memory once and by its
// other M - 1 lanes from L1/L2.  The handler and the slot merge are a few
// hundred integer operations a lane.
// Design: one thread per (state, slot) in a grid-stride loop, lanes of a
// state adjacent; the lane is paxos_deliver.cuh's device code, shared with
// K7, and the boundary re-reads the successor's six server words it just
// wrote.
#include "paxos_deliver.cuh"

namespace {

template <int C>
__global__ void paxos_step_kernel(const uint32_t* __restrict__ states,
                                  int64_t f, uint32_t max_round,
                                  uint32_t* __restrict__ nexts,
                                  uint8_t* __restrict__ valid,
                                  uint8_t* __restrict__ flags) {
  using G = paxos::Geom<C>;
  const int64_t n = f * G::M;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    const int64_t s = t / G::M;
    const int k = static_cast<int>(t - s * G::M);
    uint32_t* out = nexts + t * G::W;
    bool ok;
    flags[t] = paxos::deliver_lane<C>(states + s * G::W, k, out, ok) ? 1 : 0;
    bool inside = true;
#pragma unroll
    for (int r = 0; r < paxos::S; ++r)
      inside = inside && (out[2 * r] & 0x3Fu) / 3u <= max_round;
    valid[t] = ok && inside ? 1 : 0;
  }
}

}  // namespace

// states: f rows of Geom<c>::W words; nexts: f * M rows of W words; valid,
// flags: f * M bytes.
extern "C" int sr_paxos_step(const uint32_t* states, int64_t f, int c,
                             uint32_t max_round, uint32_t* nexts,
                             uint8_t* valid, uint8_t* flags,
                             cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 128;
#define LAUNCH(C)                                                          \
  paxos_step_kernel<C><<<sr::grid_for(f * paxos::Geom<C>::M, kThreads),    \
                         kThreads, 0, stream>>>(states, f, max_round, nexts, \
                                                valid, flags)
  PAXOS_DISPATCH(c, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
