// K17: the trap counter's step and property conditions; K21: GridWalk's,
// and K21g its gang entry; K24: CapCounter's, solo and gang.
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
//
// K21g replaces stateright_tpu/models/fixtures.py:386 GridWalkCompiled
// .gang_step, :390 gang_boundary and :397 gang_property_conds: K21 for K jobs
// of F states each in one launch, job j's bound read from consts[j] (the
// gang wave's u32[K, 1] constants), so every bound shares the launch.  Bound:
// bytes -- per state 4 bytes read, 8 + 2 + 2 written (the job's constant is
// one word per F states); one thread per (job, state) in a grid-stride loop.
//
// K24 replaces stateright_tpu/models/fixtures.py:456 CapCounterCompiled.step
// and :464 property_conds (the solo entry, limit and cap as arguments) and
// :484 gang_step and :492 gang_property_conds (the gang entry, consts[j] =
// [limit, cap]): for each one-word state n, the lane n + 1 (u32 wrap-around),
// valid iff n < limit, and the conditions n >= 0 ("counts up", always true
// in u32), n <= cap ("within cap") and n == limit ("reaches limit").  Every
// comparison is unsigned 32-bit, so a cap or limit of 2**31 or more compares
// as the JAX u32 lanes do.  Bound: bytes -- 4 bytes read, 4 + 1 + 3 written
// a state; one thread per state (per job and state) in a grid-stride loop.
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

__device__ __forceinline__ void grid_state(uint32_t w, uint32_t bound,
                                           int64_t s, uint32_t* nexts,
                                           uint8_t* valid, uint8_t* conds) {
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

__global__ void grid_kernel(const uint32_t* __restrict__ states, int64_t f,
                            uint32_t bound, uint32_t* __restrict__ nexts,
                            uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ conds) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < f; s += stride)
    grid_state(states[s], bound, s, nexts, valid, conds);
}

__global__ void grid_gang_kernel(const uint32_t* __restrict__ states,
                                 const uint32_t* __restrict__ consts,
                                 int64_t k, int64_t f,
                                 uint32_t* __restrict__ nexts,
                                 uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ conds) {
  const int64_t n = k * f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < n; s += stride)
    grid_state(states[s], consts[s / f], s, nexts, valid, conds);
}

__device__ __forceinline__ void cap_state(uint32_t n, uint32_t limit,
                                          uint32_t cap, int64_t s,
                                          uint32_t* nexts, uint8_t* valid,
                                          uint8_t* conds) {
  nexts[s] = n + 1u;
  valid[s] = n < limit;
  conds[3 * s] = 1;  // n >= 0 holds for every u32
  conds[3 * s + 1] = n <= cap;
  conds[3 * s + 2] = n == limit;
}

__global__ void cap_kernel(const uint32_t* __restrict__ states, int64_t f,
                           uint32_t limit, uint32_t cap,
                           uint32_t* __restrict__ nexts,
                           uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ conds) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < f; s += stride)
    cap_state(states[s], limit, cap, s, nexts, valid, conds);
}

__global__ void cap_gang_kernel(const uint32_t* __restrict__ states,
                                const uint32_t* __restrict__ consts,
                                int64_t k, int64_t f,
                                uint32_t* __restrict__ nexts,
                                uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ conds) {
  const int64_t n = k * f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < n; s += stride) {
    const int64_t j = s / f;
    cap_state(states[s], consts[2 * j], consts[2 * j + 1], s, nexts, valid,
              conds);
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

// K21g.  states: k * f one-word rows (job-major); consts: k words, each
// job's bound; nexts: k * f * 2 words; valid: k * f * 2 bytes; conds:
// k * f * 2 bytes.
extern "C" int sr_grid_walk_gang(const uint32_t* states, const uint32_t* consts,
                                 int64_t k, int64_t f, uint32_t* nexts,
                                 uint8_t* valid, uint8_t* conds,
                                 cudaStream_t stream) {
  if (k <= 0 || f <= 0) return 0;
  constexpr int kThreads = 256;
  grid_gang_kernel<<<sr::grid_for(k * f, kThreads), kThreads, 0, stream>>>(
      states, consts, k, f, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}

// K24, solo.  states: f one-word rows; nexts: f words; valid: f bytes;
// conds: f * 3 bytes.
extern "C" int sr_cap_counter(const uint32_t* states, int64_t f, uint32_t limit,
                              uint32_t cap, uint32_t* nexts, uint8_t* valid,
                              uint8_t* conds, cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  cap_kernel<<<sr::grid_for(f, kThreads), kThreads, 0, stream>>>(
      states, f, limit, cap, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}

// K24, gang.  states: k * f one-word rows (job-major); consts: k * 2 words,
// each job's [limit, cap]; nexts: k * f words; valid: k * f bytes; conds:
// k * f * 3 bytes.
extern "C" int sr_cap_counter_gang(const uint32_t* states,
                                   const uint32_t* consts, int64_t k,
                                   int64_t f, uint32_t* nexts, uint8_t* valid,
                                   uint8_t* conds, cudaStream_t stream) {
  if (k <= 0 || f <= 0) return 0;
  constexpr int kThreads = 256;
  cap_gang_kernel<<<sr::grid_for(k * f, kThreads), kThreads, 0, stream>>>(
      states, consts, k, f, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}
