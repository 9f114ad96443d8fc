// K6: the property conditions of packed paxos rows.
//
// Replaces stateright_tpu/models/paxos_compiled.py:919 property_conds and,
// through register_lin.cuh, register_compiled_common.py:273
// device_linearizable.  Per state, in the order of the model's properties:
//   linearizable    the register history has a linearization (the DP);
//   value chosen    a GetOk with a non-null value is in flight;
//   never decided   no server record has its decided bit (only when the
//                   model has that property).
//
// Bound: bytes up to C = 3, where the DP is a few hundred register
// operations a state; operations from C = 4 (40 DP words a state, 896 at
// C = 6, each updated 2C x 2C times at most).
// Design: a group of reglin::Dims<C>::L threads per state -- one thread up
// to C = 4, with the DP in its registers; a warp from C = 5, each thread
// holding a slice of the DP's words (register_lin.cuh).  The group scans
// the row's slot words in turn, each thread a stride of them, and thread 0
// of the group writes the state's conds.
#include "paxos_common.cuh"
#include "register_lin.cuh"

namespace {

template <int C>
__global__ void paxos_conds_kernel(const uint32_t* __restrict__ states,
                                   int64_t f, int never_decided,
                                   uint8_t* __restrict__ conds) {
  using G = paxos::Geom<C>;
  constexpr int L = reglin::Dims<C>::L;
  const int p = never_decided ? 3 : 2;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int r = static_cast<int>(tid % L);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / L;
  // Every thread of a group runs the same trip count (blockDim.x is a
  // multiple of 32), as the DP's warp collectives need.
  for (int64_t s = tid / L; s < f; s += stride) {
    const uint32_t* row = states + s * G::W;
    uint32_t tw[C];
#pragma unroll
    for (int i = 0; i < C; ++i) tw[i] = row[G::TST0 + i];
    bool chosen = false;
#pragma unroll
    for (int k0 = 0; k0 < G::M; k0 += L) {
      const uint32_t code = row[paxos::NET0 + k0 + r];
      const uint32_t e = code - 1u;
      chosen |= code != 0u && (e >> 19) == paxos::T_GETOK && (e & 0x3FFFu) != 0u;
    }
    chosen = reglin::group_any<L>(chosen);
    const bool lin = reglin::linearizable<C>(tw, r);
    if (r != 0) continue;
    uint8_t* out = conds + s * p;
    out[0] = lin ? 1 : 0;
    out[1] = chosen ? 1 : 0;
    if (never_decided) {
      bool decided = false;
#pragma unroll
      for (int i = 0; i < paxos::S; ++i)
        decided |= paxos::ext(row[2 * i], row[2 * i + 1], G::F_DECIDED, 1) == 1u;
      out[2] = decided ? 0 : 1;
    }
  }
}

}  // namespace

// states: f rows of Geom<c>::W words; conds: f * (2 or 3) bytes.
extern "C" int sr_paxos_conds(const uint32_t* states, int64_t f, int c,
                              int never_decided, uint8_t* conds,
                              cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 128;
#define LAUNCH(C)                                                        \
  paxos_conds_kernel<C><<<sr::grid_for(f * reglin::Dims<C>::L, kThreads), \
                          kThreads, 0, stream>>>(states, f, never_decided, \
                                                 conds)
  PAXOS_DISPATCH(c, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
