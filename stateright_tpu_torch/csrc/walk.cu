// K18: the device walk -- a batch of random-trace walkers, one step a launch.
//
// Replaces stateright_tpu/parallel/simulation_tpu.py:49 build_walk: the
// walk body (:112-199), its first draw (:106-109), the leftover-eventually
// pass (:230-238), and the checker's per-walker keys (:324-330).  Per
// walker and step, in the JAX order: the boundary exit, the cycle check of
// the state's fingerprint against the walker's history (only its first
// `appended` entries), the append of fingerprint and row, the count, the
// ALWAYS/SOMETIMES latches (a discovery's index is appended - 1, NO_STEP
// 0xFFFFFFFF until then), the eventually-bits, the step flag of a counted
// state, the fault hook's lane counters and blocked lanes, JAX's split +
// randint draw (threefry.cuh), the choice of the (j + 1)-th valid lane
// (lane 0 with none), the advance, and done.  Every walker draws every
// step, done or not, so the key stream never depends on the path.
//
// The fault hook (an ensemble, ensemble/engine.py): lanes valid at a
// counted state advance their datagram counters (ctr += valid) before the
// blocked lanes K19 computed are cleared -- the JAX FateLaneHook.apply's
// n_ctr + valid and valid & ~masked & (t < horizon).
//
// Layout: u32 words; state [B, W]; the fingerprint history [T, B], step
// major, so a warp's history reads at one step coalesce; trace [B, T, W]
// (the JAX return contract); keys [B, 2]; nexts [B, A, W]; valid, blocked
// [B, A] bytes; conds [B, P] bytes; disc [B, P]; ctr [B, A].
//
// Bound: bytes.  A walker's step reads its fingerprint, its history prefix
// (8 bytes an entry), A valid bytes, P cond bytes, its row and the chosen
// successor, and writes a history entry, a trace row, its row and key; six
// Threefry-2x32 hashes (about 500 integer operations) are far below the
// card's integer rate at these byte counts.
// Design: one thread per walker in a grid-stride loop; the history scan
// stops at the first match.  Simple and correct first: a walker's W-word
// row copies are strided across a warp (W words apart).
#include "sr_common.cuh"
#include "threefry.cuh"

namespace {

constexpr uint32_t NO_STEP = 0xFFFFFFFFu;

__device__ __forceinline__ tf::Key load_key(const uint32_t* keys, int64_t b) {
  return tf::Key{keys[2 * b], keys[2 * b + 1]};
}

__device__ __forceinline__ void store_key(uint32_t* keys, int64_t b, tf::Key k) {
  keys[2 * b] = k.k0;
  keys[2 * b + 1] = k.k1;
}

__global__ void keys_kernel(uint32_t k0, uint32_t k1, uint32_t w0, int64_t n,
                            uint32_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    store_key(keys, b, tf::fold_in(tf::Key{k0, k1}, w0 + static_cast<uint32_t>(b)));
  }
}

__global__ void init_kernel(int64_t n, int n_init, int w,
                            const uint32_t* __restrict__ init,
                            uint32_t* __restrict__ keys,
                            uint32_t* __restrict__ state) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    tf::Key key, sub;
    tf::split(load_key(keys, b), key, sub);
    store_key(keys, b, key);
    const int idx = tf::randint(sub, static_cast<uint32_t>(n_init));
    for (int i = 0; i < w; ++i) state[b * w + i] = init[idx * w + i];
  }
}

__global__ void step_kernel(
    int t_max, int64_t n, int w, int a, int p, uint32_t always,
    uint32_t sometimes, uint32_t eventually, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ lo, const uint8_t* __restrict__ in_bound,
    const uint32_t* __restrict__ nexts, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ conds, const uint8_t* __restrict__ flags,
    const uint8_t* __restrict__ blocked, uint32_t* __restrict__ ctr,
    uint32_t* __restrict__ state, uint32_t* __restrict__ hist_hi,
    uint32_t* __restrict__ hist_lo, uint32_t* __restrict__ trace,
    uint32_t* __restrict__ ebits, uint32_t* __restrict__ disc,
    uint8_t* __restrict__ done, uint32_t* __restrict__ counted,
    uint32_t* __restrict__ appended, uint8_t* __restrict__ flag,
    uint32_t* __restrict__ keys) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    const bool active = !done[b];
    const bool end_boundary = active && in_bound != nullptr && !in_bound[b];
    const uint32_t h = hi[b], l = lo[b];
    uint32_t app = appended[b];
    bool seen = false;
    for (uint32_t i = 0; i < app && !seen; ++i) {
      seen = hist_hi[i * n + b] == h && hist_lo[i * n + b] == l;
    }
    const bool do_append = active && !end_boundary;
    uint32_t* row = state + b * w;
    if (do_append) {
      hist_hi[app * n + b] = h;
      hist_lo[app * n + b] = l;
      uint32_t* tr = trace + (b * t_max + app) * w;
      for (int k = 0; k < w; ++k) tr[k] = row[k];
      app += 1;
      appended[b] = app;
    }
    const bool end_cycle = do_append && seen;
    const bool count_this = do_append && !seen;
    if (count_this) {
      counted[b] += 1;
      const uint32_t here = app - 1;
      uint32_t eb = ebits[b];
      int bit = 0;
      for (int q = 0; q < p; ++q) {
        const bool c = conds[b * p + q] != 0;
        const uint32_t mask = 1u << q;
        bool hit = false;
        if (always & mask) {
          hit = !c;
        } else if (sometimes & mask) {
          hit = c;
        } else if (eventually & mask) {
          if (c) eb &= ~(1u << bit);
          ++bit;
        }
        if (hit && disc[b * p + q] == NO_STEP) disc[b * p + q] = here;
      }
      ebits[b] = eb;
      if (flags != nullptr && flags[b]) flag[b] = 1;
    }
    // The lanes valid at a counted state; the hook counts each as one
    // datagram attempt, then drops the blocked ones.
    const uint8_t* vrow = valid + b * a;
    uint32_t v = 0;
    if (count_this) {
      for (int k = 0; k < a; ++k) {
        if (!vrow[k]) continue;
        if (ctr != nullptr) ctr[b * a + k] += 1u;
        if (blocked == nullptr || !blocked[b * a + k]) ++v;
      }
    }
    tf::Key key, sub;
    tf::split(load_key(keys, b), key, sub);
    store_key(keys, b, key);
    const uint32_t j = static_cast<uint32_t>(tf::randint(sub, v > 0u ? v : 1u));
    if (v > 0u) {  // count_this: advance to the (j + 1)-th valid lane
      uint32_t seen_lanes = 0;
      int lane = 0;
      for (int k = 0; k < a; ++k) {
        if (vrow[k] && (blocked == nullptr || !blocked[b * a + k]) &&
            ++seen_lanes == j + 1u) {
          lane = k;
          break;
        }
      }
      const uint32_t* src = nexts + (b * a + lane) * w;
      for (int k = 0; k < w; ++k) row[k] = src[k];
    }
    const bool terminal = count_this && v == 0u;
    if (end_boundary || end_cycle || terminal) done[b] = 1;
  }
}

__global__ void finish_kernel(int64_t n, int p, uint32_t eventually,
                              const uint8_t* __restrict__ done,
                              const uint32_t* __restrict__ ebits,
                              const uint32_t* __restrict__ appended,
                              uint32_t* __restrict__ disc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       b < n; b += stride) {
    if (!done[b]) continue;  // cut by the depth bound: no leftover check
    const uint32_t eb = ebits[b];
    int bit = 0;
    for (int q = 0; q < p; ++q) {
      if (!(eventually & (1u << q))) continue;
      if (((eb >> bit) & 1u) && disc[b * p + q] == NO_STEP)
        disc[b * p + q] = appended[b] - 1u;
      ++bit;
    }
  }
}

constexpr int kThreads = 128;

}  // namespace

// keys: n rows of 2 words, fold_in((k0, k1), w0 + b).
extern "C" int sr_walk_keys(uint32_t k0, uint32_t k1, uint32_t w0, int64_t n,
                            uint32_t* keys, cudaStream_t stream) {
  if (n <= 0) return 0;
  keys_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(k0, k1, w0, n, keys);
  return static_cast<int>(cudaGetLastError());
}

// init: n_init rows of w words; keys (in and out): n rows of 2; state: n
// rows of w, written.
extern "C" int sr_walk_init(int64_t n, int n_init, int w, const uint32_t* init,
                            uint32_t* keys, uint32_t* state, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_init <= 0) return static_cast<int>(cudaErrorInvalidValue);
  init_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      n, n_init, w, init, keys, state);
  return static_cast<int>(cudaGetLastError());
}

// One step t of n walkers: see the layout above.  in_bound, flags, blocked
// and ctr may be null (no boundary, no step flags, no fault hook; blocked
// and ctr come together).  always/sometimes/eventually: bit q marks
// property q's expectation (p <= 32).
extern "C" int sr_walk_step(
    int t, int t_max, int64_t n, int w, int a, int p, uint32_t always,
    uint32_t sometimes, uint32_t eventually, const uint32_t* hi,
    const uint32_t* lo, const uint8_t* in_bound, const uint32_t* nexts,
    const uint8_t* valid, const uint8_t* conds, const uint8_t* flags,
    const uint8_t* blocked, uint32_t* ctr, uint32_t* state, uint32_t* hist_hi,
    uint32_t* hist_lo, uint32_t* trace, uint32_t* ebits, uint32_t* disc,
    uint8_t* done, uint32_t* counted, uint32_t* appended, uint8_t* flag,
    uint32_t* keys, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (p > 32 || t < 0 || t >= t_max || (blocked == nullptr) != (ctr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  step_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      t_max, n, w, a, p, always, sometimes, eventually, hi, lo, in_bound,
      nexts, valid, conds, flags, blocked, ctr, state, hist_hi, hist_lo, trace,
      ebits, disc, done, counted, appended, flag, keys);
  return static_cast<int>(cudaGetLastError());
}

// The leftover-eventually pass after the last step.
extern "C" int sr_walk_finish(int64_t n, int p, uint32_t eventually,
                              const uint8_t* done, const uint32_t* ebits,
                              const uint32_t* appended, uint32_t* disc,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (p > 32) return static_cast<int>(cudaErrorInvalidValue);
  finish_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      n, p, eventually, done, ebits, appended, disc);
  return static_cast<int>(cudaGetLastError());
}
