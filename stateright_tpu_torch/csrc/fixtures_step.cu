// K17: the trap counter's step and property conditions; K21: GridWalk's.
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
//
// K21 replaces stateright_tpu/models/fixtures.py:337 GridWalkCompiled.step,
// :347 boundary and :354 property_conds: for each one-word state w = x |
// y << 16, the lanes w + 1 ("right") and w + (1 << 16) ("up") with u32
// wrap-around, each valid iff its successor lies in the box (w' & 0xFFFF)
// <= bound && (w' >> 16) <= bound (the JAX wave_eval's boundary AND), and the
// conditions "in bounds" (x <= bound && y <= bound) and "reaches corner" (x ==
// bound && y == bound).  Bound: bytes -- 4 bytes read, 8 + 2 + 2 written a
// state, a dozen integer operations; one thread per state in a grid-stride
// loop, as K17.
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

__device__ __forceinline__ bool in_box(uint32_t w, uint32_t bound) {
  return (w & 0xFFFFu) <= bound && (w >> 16) <= bound;
}

__global__ void grid_kernel(const uint32_t* __restrict__ states, int64_t f,
                            uint32_t bound, uint32_t* __restrict__ nexts,
                            uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ conds) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < f; s += stride) {
    const uint32_t w = states[s];
    const uint32_t right = w + 1u;
    const uint32_t up = w + (1u << 16);
    const uint32_t x = w & 0xFFFFu;
    const uint32_t y = w >> 16;
    nexts[2 * s] = right;
    nexts[2 * s + 1] = up;
    valid[2 * s] = in_box(right, bound);
    valid[2 * s + 1] = in_box(up, bound);
    conds[2 * s] = x <= bound && y <= bound;
    conds[2 * s + 1] = x == bound && y == bound;
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

// K21.  states: f one-word rows; nexts: f * 2 words; valid: f * 2 bytes;
// conds: f * 2 bytes.
extern "C" int sr_grid_walk(const uint32_t* states, int64_t f, uint32_t bound,
                            uint32_t* nexts, uint8_t* valid, uint8_t* conds,
                            cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  grid_kernel<<<sr::grid_for(f, kThreads), kThreads, 0, stream>>>(
      states, f, bound, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}
