// K13: the ping-pong step, boundary and property conditions.
//
// Replaces stateright_tpu/models/ping_pong_compiled.py:138 step, :208
// boundary and :213 property_conds (with the engine's valid &= boundary of
// stateright_tpu/parallel/wave_common.py:358-359): for each state and lane,
// Deliver(e) for each of the E = 2 (max_nat + 2) possible envelopes and,
// on a lossy network, Drop(e) after them.  A Deliver is valid when the
// envelope is present and the receiver's counter equals the message's
// value (any other delivery is a handler no-op, which the unordered
// network suppresses); it bumps the counter, sends the answer and sets the
// last-delivered marker to 1 + e, leaving the envelope in place.  A Drop
// is valid when the envelope is present and clears its bit.  Either lane
// is then valid only if the successor is within the boundary (both
// counters at most max_nat) -- unless bounded is 0: the device walk
// (parallel/simulation_gpu.py) takes the JAX step alone and tests the
// boundary of the state it stands on.  Lane 0 of each state also writes
// the state's six property conditions.
//
// Row: two words, lo | hi << 32 -- counters at bits 0-3 and 4-7, the
// envelope bitmap from bit 8, then the 5-bit marker.  Every lane's
// arithmetic is the JAX code's, word for word, on the 64-bit pair (no bit
// ever reaches 44), including the successors of invalid lanes.
//
// Bound: bytes.  Each lane writes its 8-byte successor and a valid byte;
// each state's 8-byte row is read once per lane from L1/L2 and once from
// memory; a lane is about twenty integer operations.
// Design: one thread per (state, lane) in a grid-stride loop, lanes of a
// state adjacent, so a warp's successor stores are 256 contiguous bytes
// and coalesce without staging.
#include "sr_common.cuh"

namespace {

constexpr int kEnvShift = 8;
constexpr int kProps = 6;

__global__ void ping_pong_kernel(const uint32_t* __restrict__ states,
                                 int64_t f, int max_nat, int lossy,
                                 int bounded,
                                 uint32_t* __restrict__ nexts,
                                 uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ conds) {
  const int half = max_nat + 2;
  const int e_count = 2 * half;
  const int a = lossy ? 2 * e_count : e_count;
  const int last_shift = kEnvShift + e_count;
  const uint64_t n_lanes = static_cast<uint64_t>(f) * a;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  const uint64_t m = static_cast<uint64_t>(max_nat);
  for (uint64_t t = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n_lanes; t += stride) {
    const uint64_t s = t / a;
    const int lane = static_cast<int>(t - s * a);
    const uint64_t bits = static_cast<uint64_t>(states[2 * s]) |
                          (static_cast<uint64_t>(states[2 * s + 1]) << 32);
    const uint64_t c0 = bits & 0xF;
    const uint64_t c1 = (bits >> 4) & 0xF;
    const int e = lane < e_count ? lane : lane - e_count;
    const bool present = (bits >> (kEnvShift + e)) & 1;
    uint64_t next;
    bool ok;
    if (lane < e_count) {  // Deliver(e)
      if (e < half) {  // Ping(e) to actor 1: count up, answer Pong(e)
        ok = present && c1 == static_cast<uint64_t>(e);
        next = (bits & ~(0xFull << 4)) | ((c1 + 1) << 4);
        next |= 1ull << (kEnvShift + half + e);
      } else {  // Pong(v) to actor 0: count up, send Ping(v + 1)
        const int v = e - half;
        ok = present && c0 == static_cast<uint64_t>(v);
        next = (bits & ~0xFull) | (c0 + 1);
        next |= 1ull << (kEnvShift + v + 1);
      }
      next = (next & ~(0x1Full << last_shift)) |
             (static_cast<uint64_t>(1 + e) << last_shift);
    } else {  // Drop(e)
      ok = present;
      next = bits & ~(1ull << (kEnvShift + e));
    }
    const bool inside = (next & 0xF) <= m && ((next >> 4) & 0xF) <= m;
    nexts[2 * t] = static_cast<uint32_t>(next);
    nexts[2 * t + 1] = static_cast<uint32_t>(next >> 32);
    valid[t] = ok && (inside || !bounded) ? 1 : 0;
    if (lane == 0) {
      const uint64_t delta = c0 > c1 ? c0 - c1 : c1 - c0;
      const bool at_max = c0 == m || c1 == m;
      const bool over_max = c0 == m + 1 || c1 == m + 1;
      uint8_t* out = conds + s * kProps;
      out[0] = delta <= 1;
      out[1] = at_max;
      out[2] = at_max;
      out[3] = over_max;
      out[4] = 1;
      out[5] = 1;
    }
  }
}

}  // namespace

// states: f rows of 2 words; nexts: f * A rows of 2 words; valid: f * A
// bytes; conds: f * 6 bytes.  A = 2 (max_nat + 2), doubled when lossy.
// bounded: 1 ANDs each lane's validity with its successor's boundary.
extern "C" int sr_ping_pong_step(const uint32_t* states, int64_t f,
                                 int max_nat, int lossy, int bounded,
                                 uint32_t* nexts,
                                 uint8_t* valid, uint8_t* conds,
                                 cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t a = 2 * (max_nat + 2) * (lossy ? 2 : 1);
  ping_pong_kernel<<<sr::grid_for(f * a, kThreads), kThreads, 0, stream>>>(
      states, f, max_nat, lossy, bounded, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}
