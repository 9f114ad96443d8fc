// K17: the trap counter's step and property conditions.
//
// Replaces stateright_tpu/models/fixtures.py:201 TrapCounterCompiled.step
// and :214 property_conds: for each one-word state n, the lanes n + 1
// (valid while n < limit; u32 wrap-around) and trap_state (valid at
// n == trap_at), and the conditions n >= 1 ("reaches one"), n == limit
// ("reaches limit"), n == trap_state ("trapped").
//
// Bound: bytes -- 4 bytes read, 8 + 2 + 3 written a state, a handful of
// integer operations.  Design: one thread per state in a grid-stride loop;
// the kernel exists so the eventually pipeline and the identity
// canonicalization run through a kernel on the card as every other path
// does.
#include "sr_common.cuh"

namespace {

__global__ void trap_kernel(const uint32_t* __restrict__ states, int64_t f,
                            uint32_t limit, uint32_t trap_at,
                            uint32_t trap_state, uint32_t* __restrict__ nexts,
                            uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ conds) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < f; s += stride) {
    const uint32_t n = states[s];
    nexts[2 * s] = n + 1u;
    nexts[2 * s + 1] = trap_state;
    valid[2 * s] = n < limit;
    valid[2 * s + 1] = n == trap_at;
    conds[3 * s] = n >= 1u;
    conds[3 * s + 1] = n == limit;
    conds[3 * s + 2] = n == trap_state;
  }
}

}  // namespace

// states: f one-word rows; nexts: f * 2 words; valid: f * 2 bytes; conds:
// f * 3 bytes.
extern "C" int sr_trap_step(const uint32_t* states, int64_t f, uint32_t limit,
                            uint32_t trap_at, uint32_t trap_state,
                            uint32_t* nexts, uint8_t* valid, uint8_t* conds,
                            cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  trap_kernel<<<sr::grid_for(f, kThreads), kThreads, 0, stream>>>(
      states, f, limit, trap_at, trap_state, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}
