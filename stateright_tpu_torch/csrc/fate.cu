// K19: the lanes a chaos ensemble's fault schedules block at a walk step.
//
// Replaces stateright_tpu/ensemble/engine.py:80 FateLaneHook.apply with
// stateright_tpu/ensemble/fate.py:94 device_fault_fate and :140
// partition_cuts inlined.  Per member k and FIFO lane l at step t: the drop
// and reorder fates of the lane's link at its datagram counter n =
// ctr[k, l] (counter-mode splitmix64 at 4n + draw + 1 over the link's
// 64-bit seed, top 32 bits -- runtime/chaos.py fault_fate_u32, here in
// native 64-bit words; the counter is formed in u32 as JAX forms it), the
// member's partition cut (its step window active and the link's ends in
// different groups, a group id < 0 in none), and its horizon.  The lane is
// blocked when cut, when a fate falls below its u32 threshold (or the
// rate's always flag is set), or when t is not below the horizon.  The
// walk kernel (K18) then counts each valid lane's attempt and clears the
// blocked ones.
//
// Bound: bytes.  A lane reads its counter, two seed words, two thresholds,
// two flags and two group ids (26 bytes, the member's three words from
// cache) and writes a byte; two splitmix finalizers are about 40 integer
// operations.
// Design: one thread per (member, lane) in a grid-stride loop.
#include "sr_common.cuh"

namespace {

__device__ __forceinline__ uint32_t fate(uint64_t seed, uint32_t n, uint32_t draw) {
  const uint32_t c = 4u * n + draw + 1u;
  uint64_t z = seed + static_cast<uint64_t>(c) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return static_cast<uint32_t>(z >> 32);
}

constexpr uint32_t FATE_DROP = 0, FATE_REORDER = 1;

__global__ void fate_kernel(
    int t, int64_t k, int lanes, const uint32_t* __restrict__ ctr,
    const uint32_t* __restrict__ link_hi, const uint32_t* __restrict__ link_lo,
    const uint32_t* __restrict__ drop_thr, const uint8_t* __restrict__ drop_always,
    const uint32_t* __restrict__ reorder_thr,
    const uint8_t* __restrict__ reorder_always,
    const int32_t* __restrict__ src_group, const int32_t* __restrict__ dst_group,
    const int32_t* __restrict__ part_at, const int32_t* __restrict__ part_heal,
    const int32_t* __restrict__ horizon, uint8_t* __restrict__ blocked) {
  const int64_t total = k * lanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t m = i / lanes;
    const uint64_t seed = (static_cast<uint64_t>(link_hi[i]) << 32) | link_lo[i];
    const uint32_t n = ctr[i];
    const int32_t at = part_at[m], heal = part_heal[m];
    const int32_t sg = src_group[i], dg = dst_group[i];
    const bool window = t >= at && (heal < 0 || t < heal);
    const bool cut = window && sg >= 0 && dg >= 0 && sg != dg;
    const bool masked = cut || drop_always[i] ||
                        fate(seed, n, FATE_DROP) < drop_thr[i] ||
                        reorder_always[i] ||
                        fate(seed, n, FATE_REORDER) < reorder_thr[i];
    blocked[i] = masked || !(t < horizon[m]) ? 1 : 0;
  }
}

}  // namespace

// ctr and the lane parameters: k rows of `lanes`; part_at, part_heal,
// horizon: k; blocked: k * lanes bytes.
extern "C" int sr_fate_mask(int t, int64_t k, int lanes, const uint32_t* ctr,
                            const uint32_t* link_hi, const uint32_t* link_lo,
                            const uint32_t* drop_thr, const uint8_t* drop_always,
                            const uint32_t* reorder_thr,
                            const uint8_t* reorder_always,
                            const int32_t* src_group, const int32_t* dst_group,
                            const int32_t* part_at, const int32_t* part_heal,
                            const int32_t* horizon, uint8_t* blocked,
                            cudaStream_t stream) {
  if (k <= 0 || lanes <= 0) return 0;
  constexpr int kThreads = 256;
  fate_kernel<<<sr::grid_for(k * lanes, kThreads), kThreads, 0, stream>>>(
      t, k, lanes, ctr, link_hi, link_lo, drop_thr, drop_always, reorder_thr,
      reorder_always, src_group, dst_group, part_at, part_heal, horizon, blocked);
  return static_cast<int>(cudaGetLastError());
}
