// K4: sortless insert-if-absent with lowest-lane election.
//
// Replaces stateright_tpu/parallel/hashset.py:365 insert_batch_claim with
// :96 _probe_rounds(elect=True) and :90 home_slot.  Same home slot, same
// linear probing, same 64-bit key set and the same answer: among the active
// lanes whose key was absent before the call, exactly the LOWEST lane of each
// key is new.  probe_ok is false only when some lane probed every slot
// without finding its key or an empty slot.
//
// Layout: slot i of the table holds the key (hi << 32) | lo as one 64-bit
// word, 0 = empty -- the JAX package's two u32 planes interleaved, so a table
// converts either way slot for slot.  A second 64-bit plane (meta) holds
// (epoch << 32) | lane for slots inserted by the call with that epoch.
//
// Bound: bytes, and latency of the dependent probe loads.  Each active lane
// reads its key (8 bytes) and every slot it probes (8 bytes each, random
// access), and the elected slot's meta word is touched a few times.
// Design: asynchronous, three launches, no per-call clearing of any
// table-sized plane.
//   (1) insert: each active lane walks its probe sequence; an empty slot is
//       claimed with a 64-bit atomicCAS of the key.  The CAS winner writes
//       meta = (epoch << 32) | lane.  A lane that meets its key (pre-present,
//       or inserted by another lane of this call) stops there.
//   (2) elect: every lane whose slot carries this call's epoch does
//       atomicMin(meta, (epoch << 32) | lane): the lowest lane of each newly
//       inserted key wins, whichever lane's CAS happened to land first.
//   (3) mark: new = meta == (epoch << 32) | lane.
// A first-come CAS alone would elect a nondeterministic representative and
// break row-log, parent and ebit equality with the JAX engine; the epoch tag
// replaces the JAX version's O(capacity) claim-plane reset per call.
// On request (a traced wave), the insert also reports its probe figures
// into probe_stats, beside the wave's other readback values: [0] the
// longest probe chain, in slots read by one lane (an atomicMax), and [1]
// the slots all lanes read (an atomicAdd), each reduced over a warp by
// shuffles first.  The JAX version's figure is its count of lockstep claim
// rounds; a lane here that loses a CAS re-reads nothing, so the longest
// chain can be lower than that count.
// The device-epoch entry (sr_insert_claim_dev) serves the fused wave loop
// (K29): the epoch is a word on the card that a one-thread launch advances
// before the three kernels read it, so every wave of a replayed CUDA graph
// tags its claims with a fresh epoch (an epoch passed by value would be
// baked into the graph, and an earlier wave's claims would look current).
#include "sr_common.cuh"

namespace {

constexpr uint32_t kNoSlot = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t home_slot(uint32_t hi, uint32_t lo,
                                              uint64_t mask) {
  return sr::fmix32(hi ^ sr::rotl32(lo, 16) ^ 0x7FEB352Du) & mask;
}

__global__ void insert_kernel(unsigned long long* __restrict__ keys,
                              unsigned long long* __restrict__ meta,
                              uint64_t capacity, const uint32_t* __restrict__ hi,
                              const uint32_t* __restrict__ lo,
                              const uint8_t* __restrict__ active, int64_t n,
                              unsigned long long epoch_tag,
                              uint32_t* __restrict__ slot_out,
                              int* __restrict__ probe_ok,
                              unsigned long long* __restrict__ probe_stats,
                              const uint32_t* __restrict__ epoch) {
  if (epoch != nullptr) epoch_tag = static_cast<unsigned long long>(*epoch) << 32;
  const uint64_t mask = capacity - 1;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned long long longest = 0, slots = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!active[i]) {
      slot_out[i] = kNoSlot;
      continue;
    }
    const unsigned long long key =
        (static_cast<unsigned long long>(hi[i]) << 32) | lo[i];
    uint64_t s = home_slot(hi[i], lo[i], mask);
    uint32_t found = kNoSlot;
    uint64_t probes = 0;
    for (; probes < capacity; ++probes) {
      // A stale read can only show 0 for a slot that is already taken (keys
      // never leave a slot during a call); the CAS below settles it.
      unsigned long long cur = keys[s];
      if (cur == 0ull) {
        cur = atomicCAS(&keys[s], 0ull, key);
        if (cur == 0ull) {
          meta[s] = epoch_tag | static_cast<unsigned long long>(i);
          found = static_cast<uint32_t>(s);
          break;
        }
      }
      if (cur == key) {
        found = static_cast<uint32_t>(s);
        break;
      }
      s = (s + 1) & mask;
    }
    slot_out[i] = found;
    if (found == kNoSlot) *probe_ok = 0;
    const unsigned long long read =
        found == kNoSlot ? capacity : static_cast<unsigned long long>(probes) + 1;
    longest = read > longest ? read : longest;
    slots += read;
  }
  if (probe_stats != nullptr) {  // uniform over the grid
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long m = __shfl_down_sync(0xffffffffu, longest, d);
      longest = m > longest ? m : longest;
      slots += __shfl_down_sync(0xffffffffu, slots, d);
    }
    if ((threadIdx.x & 31) == 0 && slots) {
      atomicMax(&probe_stats[0], longest);
      atomicAdd(&probe_stats[1], slots);
    }
  }
}

__global__ void elect_kernel(unsigned long long* __restrict__ meta,
                             const uint32_t* __restrict__ slot, int64_t n,
                             unsigned long long epoch_tag,
                             const uint32_t* __restrict__ epoch) {
  if (epoch != nullptr) epoch_tag = static_cast<unsigned long long>(*epoch) << 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t s = slot[i];
    if (s == kNoSlot) continue;
    const unsigned long long tag = epoch_tag | static_cast<unsigned long long>(i);
    const unsigned long long m = meta[s];
    if ((m >> 32) == (epoch_tag >> 32) && tag < m) atomicMin(&meta[s], tag);
  }
}

__global__ void mark_kernel(const unsigned long long* __restrict__ meta,
                            const uint32_t* __restrict__ slot, int64_t n,
                            unsigned long long epoch_tag,
                            uint8_t* __restrict__ is_new,
                            const uint32_t* __restrict__ epoch) {
  if (epoch != nullptr) epoch_tag = static_cast<unsigned long long>(*epoch) << 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t s = slot[i];
    is_new[i] =
        (s != kNoSlot &&
         meta[s] == (epoch_tag | static_cast<unsigned long long>(i)))
            ? 1
            : 0;
  }
}

}  // namespace

// keys, meta: capacity 64-bit words (capacity a power of two <= 2^32);
// hi, lo: n key words; active: n bytes; slot_out: n words of scratch (the
// key's slot, 0xFFFFFFFF for inactive or unplaced lanes); is_new: n bytes;
// probe_ok: one int the caller sets to 1; probe_stats: two zeroed 64-bit
// words (longest chain, slots read), or null.  epoch >= 1, distinct per
// call on one meta plane, increasing.  Blocks are whole warps.
extern "C" int sr_insert_claim(unsigned long long* keys,
                               unsigned long long* meta, uint64_t capacity,
                               const uint32_t* hi, const uint32_t* lo,
                               const uint8_t* active, int64_t n,
                               uint32_t epoch, uint32_t* slot_out,
                               uint8_t* is_new, int* probe_ok,
                               unsigned long long* probe_stats,
                               cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const unsigned grid = sr::grid_for(n, kThreads);
  const unsigned long long tag = static_cast<unsigned long long>(epoch) << 32;
  insert_kernel<<<grid, kThreads, 0, stream>>>(keys, meta, capacity, hi, lo,
                                               active, n, tag, slot_out,
                                               probe_ok, probe_stats, nullptr);
  elect_kernel<<<grid, kThreads, 0, stream>>>(meta, slot_out, n, tag, nullptr);
  mark_kernel<<<grid, kThreads, 0, stream>>>(meta, slot_out, n, tag, is_new,
                                             nullptr);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void advance_epoch_kernel(uint32_t* epoch) { *epoch += 1u; }

}  // namespace

// The device-epoch entry: as sr_insert_claim, with the epoch the word at
// `epoch`, advanced by one on the card first (the caller keeps it below
// 0xFFFFFFFF and clears meta when it wraps).
extern "C" int sr_insert_claim_dev(unsigned long long* keys,
                                   unsigned long long* meta,
                                   uint64_t capacity, const uint32_t* hi,
                                   const uint32_t* lo, const uint8_t* active,
                                   int64_t n, uint32_t* epoch,
                                   uint32_t* slot_out, uint8_t* is_new,
                                   int* probe_ok,
                                   unsigned long long* probe_stats,
                                   cudaStream_t stream) {
  advance_epoch_kernel<<<1, 1, 0, stream>>>(epoch);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int kThreads = 256;
  const unsigned grid = sr::grid_for(n, kThreads);
  insert_kernel<<<grid, kThreads, 0, stream>>>(keys, meta, capacity, hi, lo,
                                               active, n, 0ull, slot_out,
                                               probe_ok, probe_stats, epoch);
  elect_kernel<<<grid, kThreads, 0, stream>>>(meta, slot_out, n, 0ull, epoch);
  mark_kernel<<<grid, kThreads, 0, stream>>>(meta, slot_out, n, 0ull, is_new,
                                             epoch);
  return static_cast<int>(cudaGetLastError());
}
