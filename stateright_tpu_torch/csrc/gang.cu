// K23: one gang wave's verdicts, expansion gate and generated counts.
//
// Replaces stateright_tpu/fleet/gang.py:216 _build_wave's per-job `one`
// (everything after the family's step, boundary and conds; the same for every
// gang family).  For job j of K, state s of F, with conds[j, s, P] and
// validity valid[j, s, A] from the family kernel (K21g, K24), the lanes
// active[j, s] that hold a frontier state, and undisc[j, P] the properties of
// job j with no witness when the wave started:
//   awaiting   an ALWAYS property still undiscovered whose cond holds, or a
//              SOMETIMES property still undiscovered whose cond fails (every
//              property not in `always` counts as SOMETIMES, as in the JAX
//              wave; EVENTUALLY properties are gang-ineligible);
//   valid      gated IN PLACE: valid[j, s, a] &= active[j, s] && awaiting;
//   generated  generated[j] = the number of lanes of job j left valid;
//   first      first[j, p] = the lowest s with active[j, s] whose cond fails
//              (ALWAYS p) or holds (SOMETIMES p), -1 where none does.  Hits
//              are masked by `active`, not by `awaiting`, as the JAX hit
//              masks are, and the host reads only this first lane of them.
// One block per job, so a job's outputs are written by one block and nothing
// depends on the order the blocks run in.  The block walks the job's states
// in rounds of blockDim.x (every lane of a warp takes part in each round, the
// ones past F with no hit); each round's first hit is a warp minimum followed
// by a shared-memory atomicMin, and the count an integer atomicAdd, which is
// exact.
//
// Bound: bytes.  Each state's P cond bytes, A valid bytes and active byte are
// read, its A valid bytes written, and per job P undisc bytes read and 4 + 4P
// bytes written; the logic is a few operations a byte.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kNone = 0xFFFFFFFFu;  // -1 as an int32

__global__ void gang_eval_kernel(const uint8_t* __restrict__ conds,
                                 uint8_t* __restrict__ valid,
                                 const uint8_t* __restrict__ active,
                                 const uint8_t* __restrict__ undisc,
                                 int64_t f, int p, int a, uint32_t always,
                                 uint32_t* __restrict__ generated,
                                 uint32_t* __restrict__ first) {
  __shared__ uint32_t first_s[32];
  __shared__ uint32_t count_s;
  const int64_t j = blockIdx.x;
  uint32_t open = 0;
  for (int q = 0; q < p; ++q)
    open |= static_cast<uint32_t>(undisc[j * p + q] != 0) << q;
  if (threadIdx.x < 32) first_s[threadIdx.x] = kNone;
  if (threadIdx.x == 0) count_s = 0;
  __syncthreads();
  uint32_t count = 0;
  for (int64_t base = 0; base < f; base += blockDim.x) {
    const int64_t s = base + threadIdx.x;
    const int64_t row = j * f + s;
    const bool live = s < f && active[row] != 0;
    uint32_t cbits = 0;
    if (s < f)
      for (int q = 0; q < p; ++q)
        cbits |= static_cast<uint32_t>(conds[row * p + q] != 0) << q;
    const bool awaiting =
        ((always & open & cbits) | (~always & open & ~cbits)) != 0u;
    if (s < f) {
      for (int l = 0; l < a; ++l) {
        const bool v = valid[row * a + l] != 0 && live && awaiting;
        valid[row * a + l] = v ? 1 : 0;
        count += v ? 1u : 0u;
      }
    }
    for (int q = 0; q < p; ++q) {
      const bool c = (cbits >> q) & 1u;
      const bool hit = live && (((always >> q) & 1u) ? !c : c);
      const uint32_t m = __reduce_min_sync(
          0xFFFFFFFFu, hit ? static_cast<uint32_t>(s) : kNone);
      if ((threadIdx.x & 31) == 0 && m != kNone) atomicMin(&first_s[q], m);
    }
  }
  if (count) atomicAdd(&count_s, count);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < p)
    first[j * p + threadIdx.x] = first_s[threadIdx.x];
  if (threadIdx.x == 0) generated[j] = count_s;
}

}  // namespace

// conds: k * f * p bytes; valid: k * f * a bytes, gated in place; active:
// k * f bytes; undisc: k * p bytes; generated: k words; first: k * p words
// (0xFFFFFFFF, i.e. -1, where no active lane hits).
extern "C" int sr_gang_eval(const uint8_t* conds, uint8_t* valid,
                            const uint8_t* active, const uint8_t* undisc,
                            int64_t k, int64_t f, int p, int a,
                            uint32_t always, uint32_t* generated,
                            uint32_t* first, cudaStream_t stream) {
  if (p > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0) return 0;
  gang_eval_kernel<<<static_cast<unsigned>(k), kThreads, 0, stream>>>(
      conds, valid, active, undisc, f, p, a, always, generated, first);
  return static_cast<int>(cudaGetLastError());
}
