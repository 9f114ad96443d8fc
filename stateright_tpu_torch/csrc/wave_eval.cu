// K8: one wave's property verdicts, expansion gate and eventually bits.
//
// Replaces stateright_tpu/parallel/wave_common.py:282 wave_eval (everything
// after the model's step and conds; model-independent).  For state s of the
// wave, at BFS position start + s, with property kinds given as bit masks
// (ALWAYS, SOMETIMES, EVENTUALLY) and `discovered` the properties with a
// discovery when the wave started:
//   awaiting   the state still contributes to some undiscovered property
//              (an ALWAYS cond that holds, a SOMETIMES cond that does not,
//              any undiscovered EVENTUALLY); the reference stops expanding
//              a state when nothing is awaited (src/checker/bfs.rs:231-281);
//   valid      gated IN PLACE: valid[s, a] &= awaiting;
//   eb         eb_in with the bits of the state's satisfied EVENTUALLY
//              conds cleared (bit b = the b-th EVENTUALLY property);
//   cands[p]   the first position whose state hits p: an ALWAYS cond that
//              fails, a SOMETIMES cond that holds, or -- for EVENTUALLY --
//              a terminal state (no valid lane left) with p's bit still
//              set; NO_ID (0xFFFFFFFF) where none does.
// The first hit is a warp minimum followed by a 64-bit atomicMin on the
// position, so the result is the lowest position whatever the order the
// blocks run in: deterministic, as the JAX argmax is.
//
// Bound: bytes.  Each state's P cond bytes, A valid bytes and eb word are
// read, and its A valid bytes and eb word written; the logic is a few
// operations a byte.
// Design: one thread per state for the conds, the eventually bits and the
// hits; the block's states own a contiguous run of A valid bytes each, which
// the whole block gates together, neighbouring threads on neighbouring bytes
// (a thread walking its own state's A bytes would stride A bytes across the
// warp), marking in shared memory which states keep a lane.  A tiny first
// launch sets the candidates to NO_ID, so the caller allocates them with no
// fill of its own.
//
// The device-count entry (sr_wave_eval_dev) serves the fused wave loop
// (K29, csrc/wave_ctl.cu), whose scalars never visit the host: the wave's
// first position and the discovered mask come from the stats vector
// (level_start, disc[P]), and the fixed-width chunk's lanes past the level
// come with an active mask -- an inactive state awaits nothing (no valid
// lane) and hits nothing, as the JAX wave_eval gates them (wave_common.py:
// 355); its eventually bits are still written.
#include "sr_common.cuh"

namespace {

constexpr unsigned long long kNoId = 0xFFFFFFFFull;

__global__ void init_kernel(unsigned long long* cands, int p) {
  const int q = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (q < p) cands[q] = kNoId;
}

__device__ __forceinline__ void first_hit(unsigned long long* cand, bool hit,
                                          uint32_t pos) {
  const uint32_t m = __reduce_min_sync(0xFFFFFFFFu, hit ? pos : 0xFFFFFFFFu);
  if ((threadIdx.x & 31) == 0 && m != 0xFFFFFFFFu)
    atomicMin(cand, static_cast<unsigned long long>(m));
}

constexpr int kThreads = 256;

__global__ void wave_eval_kernel(const uint8_t* __restrict__ conds, int64_t f,
                                 int p, uint8_t* __restrict__ valid, int a,
                                 const uint32_t* __restrict__ eb_in,
                                 uint32_t* __restrict__ eb_out, int64_t start,
                                 uint32_t always, uint32_t sometimes,
                                 uint32_t eventually, uint32_t discovered,
                                 unsigned long long* __restrict__ cands,
                                 const uint32_t* __restrict__ stats,
                                 const uint8_t* __restrict__ active) {
  __shared__ uint8_t awaiting_s[kThreads];
  __shared__ uint8_t any_s[kThreads];
  if (stats != nullptr) {  // the device-count entry: scalars from the stats
    start = stats[0];
    discovered = 0u;
    for (int q = 0; q < p; ++q)
      if (stats[8 + q] != 0xFFFFFFFFu) discovered |= 1u << q;
  }
  // One state a thread, no grid-stride loop: every lane of a warp reaches
  // the warp minimum, those past f with no hit.
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t s = s0 + threadIdx.x;
  const bool in_range = s < f;
  const bool live = in_range && (active == nullptr || active[s] != 0);
  uint32_t cbits = 0;
  uint32_t eb = 0;
  bool awaiting = false;
  if (in_range) {
    for (int q = 0; q < p; ++q)
      cbits |= static_cast<uint32_t>(conds[s * p + q] != 0) << q;
    const uint32_t open = ~discovered;
    awaiting = live && ((always & open & cbits) != 0u ||
                        (sometimes & open & ~cbits) != 0u ||
                        (eventually & open) != 0u);
    eb = eb_in[s];
    int bit = 0;
    for (int q = 0; q < p; ++q) {
      if (!((eventually >> q) & 1u)) continue;
      if ((cbits >> q) & 1u) eb &= ~(1u << bit);
      ++bit;
    }
    eb_out[s] = eb;
  }
  awaiting_s[threadIdx.x] = awaiting ? 1 : 0;
  any_s[threadIdx.x] = 0;
  __syncthreads();
  // The block's states own a contiguous run of valid bytes: gate it with
  // neighbouring threads on neighbouring bytes.
  const int64_t block = blockDim.x;
  const int64_t states = f - s0 < block ? f - s0 : block;  // s0 < f
  uint8_t* run = valid + s0 * a;
  for (int64_t i = threadIdx.x; i < states * a; i += block) {
    const int64_t ls = i / a;
    const bool v = run[i] != 0 && awaiting_s[ls];
    run[i] = v ? 1 : 0;
    if (v) any_s[ls] = 1;  // every writer stores 1
  }
  __syncthreads();
  const bool any_valid = any_s[threadIdx.x] != 0;
  const uint32_t pos = static_cast<uint32_t>(start + s);
  int bit = 0;
  for (int q = 0; q < p; ++q) {
    bool hit;
    if ((always >> q) & 1u) {
      hit = live && !((cbits >> q) & 1u);
    } else if ((sometimes >> q) & 1u) {
      hit = live && ((cbits >> q) & 1u);
    } else {  // EVENTUALLY: a terminal state that still owes this bit
      hit = live && !any_valid && ((eb >> bit) & 1u);
      ++bit;
    }
    first_hit(&cands[q], hit, pos);
  }
}

}  // namespace

// conds: f * p bytes; valid: f * a bytes, gated in place; eb_in, eb_out: f
// words; cands: p int64 words, written NO_ID or the first hit's position.
extern "C" int sr_wave_eval(const uint8_t* conds, int64_t f, int p,
                            uint8_t* valid, int a, const uint32_t* eb_in,
                            uint32_t* eb_out, int64_t start, uint32_t always,
                            uint32_t sometimes, uint32_t eventually,
                            uint32_t discovered, unsigned long long* cands,
                            cudaStream_t stream) {
  if (p > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0) init_kernel<<<1, 32, 0, stream>>>(cands, p);
  if (f > 0) {
    const unsigned blocks = static_cast<unsigned>((f + kThreads - 1) / kThreads);
    wave_eval_kernel<<<blocks, kThreads, 0, stream>>>(
        conds, f, p, valid, a, eb_in, eb_out, start, always, sometimes,
        eventually, discovered, cands, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device-count entry: as sr_wave_eval, with the first position and the
// discovered mask read from stats (level_start at [0], disc[p] at [8..])
// and states whose active byte is 0 gated out.
extern "C" int sr_wave_eval_dev(const uint8_t* conds, int64_t f, int p,
                                uint8_t* valid, int a, const uint32_t* eb_in,
                                uint32_t* eb_out, const uint32_t* stats,
                                const uint8_t* active, uint32_t always,
                                uint32_t sometimes, uint32_t eventually,
                                unsigned long long* cands,
                                cudaStream_t stream) {
  if (p > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0) init_kernel<<<1, 32, 0, stream>>>(cands, p);
  if (f > 0) {
    const unsigned blocks = static_cast<unsigned>((f + kThreads - 1) / kThreads);
    wave_eval_kernel<<<blocks, kThreads, 0, stream>>>(
        conds, f, p, valid, a, eb_in, eb_out, 0, always, sometimes,
        eventually, 0u, cands, stats, active);
  }
  return static_cast<int>(cudaGetLastError());
}
