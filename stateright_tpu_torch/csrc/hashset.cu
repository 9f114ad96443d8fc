// K4: sortless insert-if-absent with lowest-lane election.
//
// Replaces stateright_tpu/parallel/hashset.py:365 insert_batch_claim with
// :96 _probe_rounds(elect=True) and :90 home_slot.  Same home slot, same
// linear probing, same 64-bit key set and the same answer: among the active
// lanes whose key was absent before the call, exactly the LOWEST lane of each
// key is new.  probe_ok is false only when some lane probed every slot
// without finding its key or an empty slot.
//
// Layout: one 16-byte slot {key, tag} a table entry.  The key is (hi << 32)
// | lo as one 64-bit word, 0 = empty -- the JAX package's two u32 planes
// interleaved, so a table converts either way slot for slot.  The tag is
// (epoch << 32) | lane for a key claimed by the call with that epoch (any
// value of another epoch is stale and means nothing).
//
// Bound: the dependent random reads of the probe chains, a sector each,
// on a table far past the 50 MB L2; for the small batches of the sharded
// owners and the small checks, the launches themselves.  Every touch of a
// slot beyond its probe is another trip to HBM, and every grid-wide pass
// a launch and a sweep over all lanes.
// Design: the tag rides in the key's own sector, so
//   (1) claim: each active lane walks its probe sequence with one 16-byte
//       load a slot.  An empty slot is claimed with one 16-byte CAS that
//       writes the key and this lane's tag together; a lane that meets its
//       key reads the tag in the same load: of another epoch, the key was
//       present before (not new, done); of this epoch and below its own
//       lane, a lower lane holds it (not new, done); else it lowers the tag
//       with a 64-bit atomicMin on the tag half and stays pending only if
//       that min took.  A CAS that loses returns the slot it lost to, which
//       is read as above.
//   (2) mark: the new bytes are read four lanes a load, and only pending
//       lanes (is_new == 2 between the passes) read their slot and tag
//       again, the four lanes' loads in flight together (the new lanes of
//       a sharded receive buffer come in runs): new = tag == (epoch << 32)
//       | lane.  The tag only falls during a call, so the lowest lane of
//       each key wins, whatever order the claims landed in, and one call's
//       answer does not depend on the scheduling of blocks.
// A new key costs three sector touches on one plane (the load, the CAS, the
// mark's read), a key present before the call its probe reads alone.  The
// mark pass's last block (a self-resetting done count in the table's two
// control words) writes probe_ok from the claim's fail word and, in the
// device entry, the advanced epoch, so either entry is two launches with
// nothing else on the stream.  A buffer of at most one tile (4,096 lanes)
// runs claim, __syncthreads, mark and the epoch in one block: one launch.
// A first-come CAS alone would elect a nondeterministic representative and
// break row-log, parent and ebit equality with the JAX engine; the epoch tag
// replaces the JAX version's O(capacity) claim-plane reset per call.
// On request (a traced wave), the claim also reports its probe figures
// into probe_stats, beside the wave's other readback values: [0] the
// longest probe chain, in slots read by one lane (an atomicMax), and [1]
// the slots all lanes read (an atomicAdd), each reduced over a warp by
// shuffles first.  The JAX version's figure is its count of lockstep claim
// rounds; a lane here that loses a CAS re-reads nothing, so the longest
// chain can be lower than that count.
// The device-epoch entry (sr_insert_claim_dev) serves the fused wave loop
// (K29): the epoch is a word on the card that the call reads as the last
// epoch and advances by one at its end, so every wave of a replayed CUDA
// graph tags its claims with a fresh epoch (an epoch passed by value would
// be baked into the graph, and an earlier wave's claims would look
// current).
#include "sr_common.cuh"

namespace {

typedef unsigned long long u64;

constexpr uint32_t kNoSlot = 0xFFFFFFFFu;
constexpr uint8_t kPending = 2;  // is_new between the passes
constexpr int kThreads = 256;
constexpr int kTileThreads = 1024;  // the one-block path
constexpr int kTileItems = 4;
constexpr int64_t kTile = kTileThreads * kTileItems;

__device__ __forceinline__ uint64_t home_slot(uint32_t hi, uint32_t lo,
                                              uint64_t mask) {
  return sr::fmix32(hi ^ sr::rotl32(lo, 16) ^ 0x7FEB352Du) & mask;
}

// One slot read whole: a 16-byte load is a single access, so the key and
// the tag it shows were in the slot together.
__device__ __forceinline__ void load_slot(const u64* p, u64& key, u64& tag) {
  asm volatile(
      "{\n\t.reg .b128 d;\n\t"
      "ld.relaxed.gpu.global.b128 d, [%2];\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(key), "=l"(tag)
      : "l"(p)
      : "memory");
}

// {key, tag} = {0, empty_tag} -> {k, t}; returns what the slot held.
__device__ __forceinline__ void cas_slot(u64* p, u64 empty_tag, u64 k, u64 t,
                                         u64& key, u64& tag) {
  asm volatile(
      "{\n\t.reg .b128 c, v, d;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 v, {%4, %5};\n\t"
      "atom.relaxed.gpu.global.cas.b128 d, [%6], c, v;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(key), "=l"(tag)
      : "l"(0ull), "l"(empty_tag), "l"(k), "l"(t), "l"(p)
      : "memory");
}

__device__ __forceinline__ u64 load_tag(const u64* p) {
  u64 t;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(t) : "l"(p) : "memory");
  return t;
}

// Claim lane `lane`'s key (tag = its epoch tag | lane): returns kPending
// where this lane may be the lowest of a key claimed in this call, else 0;
// `slot` is where the key lies (kNoSlot: probed the whole table), `reads`
// the slots read.
__device__ __forceinline__ uint8_t claim(u64* __restrict__ slots,
                                         uint64_t capacity, uint32_t hi,
                                         uint32_t lo, u64 tag, uint32_t& slot,
                                         u64& reads) {
  const uint64_t mask = capacity - 1;
  const u64 key = (static_cast<u64>(hi) << 32) | lo;
  uint64_t s = home_slot(hi, lo, mask);
  for (uint64_t probes = 0; probes < capacity; ++probes) {
    u64* p = slots + 2 * s;
    u64 k, t;
    load_slot(p, k, t);
    while (k == 0ull) {
      u64 was_t;
      cas_slot(p, t, key, tag, k, was_t);
      if (k == 0ull && was_t == t) {  // claimed: key and tag in together
        slot = static_cast<uint32_t>(s);
        reads = probes + 1;
        return kPending;
      }
      t = was_t;  // lost to another key, or (still empty) a tag moved
    }
    if (k == key) {
      slot = static_cast<uint32_t>(s);
      reads = probes + 1;
      // Another epoch: present before the call.  A lower tag of this
      // epoch: a lower lane holds the key.
      if ((t >> 32) != (tag >> 32) || t < tag) return 0;
      return atomicMin(p + 1, tag) > tag ? kPending : 0;
    }
    s = (s + 1) & mask;
  }
  slot = kNoSlot;
  reads = capacity;
  return 0;
}

// The probe figures of a block's lanes: a warp's by shuffles, then one
// atomic each.  Called by every thread of the block.
__device__ __forceinline__ void add_probe_stats(u64* probe_stats, u64 longest,
                                                u64 reads) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const u64 m = __shfl_down_sync(0xffffffffu, longest, d);
    longest = m > longest ? m : longest;
    reads += __shfl_down_sync(0xffffffffu, reads, d);
  }
  if ((threadIdx.x & 31) == 0 && reads) {
    atomicMax(&probe_stats[0], longest);
    atomicAdd(&probe_stats[1], reads);
  }
}

__global__ void __launch_bounds__(kThreads) claim_kernel(
    u64* __restrict__ slots, uint64_t capacity, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ lo, const uint8_t* __restrict__ active,
    int64_t n, uint32_t epoch, const uint32_t* __restrict__ epoch_word,
    uint32_t* __restrict__ slot_out, uint8_t* __restrict__ is_new,
    unsigned* __restrict__ ctl, u64* __restrict__ probe_stats) {
  if (epoch_word != nullptr) epoch = *epoch_word + 1u;
  const u64 tag0 = static_cast<u64>(epoch) << 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  u64 longest = 0, reads = 0;
  int fail = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t s = kNoSlot;
    uint8_t state = 0;
    if (active[i]) {
      u64 r;
      state = claim(slots, capacity, hi[i], lo[i], tag0 | static_cast<u64>(i), s, r);
      fail |= s == kNoSlot;
      longest = r > longest ? r : longest;
      reads += r;
    }
    slot_out[i] = s;
    is_new[i] = state;
  }
  if (__syncthreads_or(fail) && threadIdx.x == 0) atomicOr(ctl + 1, 1u);
  if (probe_stats != nullptr) add_probe_stats(probe_stats, longest, reads);
}

// The pending lanes among lanes 4v .. 4v + 3, whose new bytes are b: a
// lane is new if its key's tag still holds its own lane.  The slots, then
// the tags, of all four are loaded before any is compared.  Four lanes a
// thread, not more: the sharded receive buffers' new lanes come in runs,
// and a run's loads spread over more threads finish sooner.
__device__ __forceinline__ void mark4(const u64* __restrict__ slots,
                                      const uint32_t* __restrict__ slot,
                                      int64_t v, uint32_t b, u64 tag0,
                                      uint8_t* __restrict__ is_new) {
  uint32_t s[4];
  u64 t[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((b >> (8 * q) & 0xFFu) == kPending) s[q] = slot[4 * v + q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if ((b >> (8 * q) & 0xFFu) == kPending)
      t[q] = load_tag(slots + 2 * static_cast<u64>(s[q]) + 1);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t i = 4 * v + q;
    if ((b >> (8 * q) & 0xFFu) == kPending)
      is_new[i] = t[q] == (tag0 | static_cast<u64>(i)) ? 1 : 0;
  }
}

// ctl[0]: blocks of this pass done; ctl[1]: the claim's fail word.  Both
// are 0 between calls: the last block out resets them.
__global__ void __launch_bounds__(kThreads) mark_kernel(
    const u64* __restrict__ slots, int64_t n, uint32_t epoch,
    uint32_t* __restrict__ epoch_word, const uint32_t* __restrict__ slot,
    uint8_t* __restrict__ is_new, unsigned* __restrict__ ctl,
    uint8_t* __restrict__ probe_ok) {
  if (epoch_word != nullptr) epoch = *epoch_word + 1u;
  const u64 tag0 = static_cast<u64>(epoch) << 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // Four lanes' bytes a load (is_new is 4-byte aligned); only pending
  // lanes (the byte 2, bit 1) read their tag.
  for (int64_t v = tid; v < n / 4; v += stride) {
    const uint32_t b = reinterpret_cast<const uint32_t*>(is_new)[v];
    if (b & 0x02020202u) mark4(slots, slot, v, b, tag0, is_new);
  }
  for (int64_t i = n / 4 * 4 + tid; i < n; i += stride) {
    if (is_new[i] == kPending)
      is_new[i] = load_tag(slots + 2 * static_cast<u64>(slot[i]) + 1) ==
                          (tag0 | static_cast<u64>(i))
                      ? 1
                      : 0;
  }
  __syncthreads();  // every thread of the block has read the epoch word
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl, 1u) == gridDim.x - 1) {
      const unsigned failed = atomicExch(ctl + 1, 0u);
      *probe_ok = failed ? 0 : 1;
      if (epoch_word != nullptr) *epoch_word = epoch;
      atomicExch(ctl, 0u);
    }
  }
}

// The whole call in one block, for at most kTile lanes: claim, a barrier,
// mark, then probe_ok and the epoch.
__global__ void __launch_bounds__(kTileThreads) tile_kernel(
    u64* __restrict__ slots, uint64_t capacity, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ lo, const uint8_t* __restrict__ active,
    int64_t n, uint32_t epoch, uint32_t* __restrict__ epoch_word,
    uint32_t* __restrict__ slot_out, uint8_t* __restrict__ is_new,
    uint8_t* __restrict__ probe_ok, u64* __restrict__ probe_stats) {
  if (epoch_word != nullptr) epoch = *epoch_word + 1u;
  const u64 tag0 = static_cast<u64>(epoch) << 32;
  uint32_t s[kTileItems];
  uint8_t state[kTileItems];
  u64 longest = 0, reads = 0;
  int fail = 0;
#pragma unroll
  for (int q = 0; q < kTileItems; ++q) {
    const int64_t i = threadIdx.x + q * kTileThreads;
    s[q] = kNoSlot;
    state[q] = 0;
    if (i < n && active[i]) {
      u64 r;
      state[q] = claim(slots, capacity, hi[i], lo[i], tag0 | static_cast<u64>(i),
                       s[q], r);
      fail |= s[q] == kNoSlot;
      longest = r > longest ? r : longest;
      reads += r;
    }
    if (i < n) slot_out[i] = s[q];
  }
  // Every claim and atomicMin of the block is in before any mark reads.
  fail = __syncthreads_or(fail);
#pragma unroll
  for (int q = 0; q < kTileItems; ++q) {
    const int64_t i = threadIdx.x + q * kTileThreads;
    if (i >= n) break;
    is_new[i] = state[q] == kPending &&
                        load_tag(slots + 2 * static_cast<u64>(s[q]) + 1) ==
                            (tag0 | static_cast<u64>(i))
                    ? 1
                    : 0;
  }
  if (probe_stats != nullptr) add_probe_stats(probe_stats, longest, reads);
  __syncthreads();  // every thread has read the epoch word
  if (threadIdx.x == 0) {
    *probe_ok = fail ? 0 : 1;
    if (epoch_word != nullptr) *epoch_word = epoch;
  }
}

int launch(u64* slots, uint64_t capacity, const uint32_t* hi,
           const uint32_t* lo, const uint8_t* active, int64_t n,
           uint32_t epoch, uint32_t* epoch_word, uint32_t* slot_out,
           uint8_t* is_new, uint8_t* probe_ok, unsigned* ctl,
           u64* probe_stats, cudaStream_t stream) {
  if (n <= kTile) {
    tile_kernel<<<1, kTileThreads, 0, stream>>>(
        slots, capacity, hi, lo, active, n, epoch, epoch_word, slot_out, is_new,
        probe_ok, probe_stats);
    return static_cast<int>(cudaGetLastError());
  }
  claim_kernel<<<sr::grid_for(n, kThreads), kThreads, 0, stream>>>(
      slots, capacity, hi, lo, active, n, epoch, epoch_word, slot_out, is_new,
      ctl, probe_stats);
  mark_kernel<<<sr::grid_for((n + 3) / 4, kThreads), kThreads, 0, stream>>>(
      slots, n, epoch, epoch_word, slot_out, is_new, ctl, probe_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// slots: capacity 16-byte {key, tag} slots, 16-byte aligned (capacity a
// power of two <= 2^32); hi, lo: n key words; active: n bytes; slot_out: n
// words (the key's slot, 0xFFFFFFFF for inactive or unplaced lanes);
// is_new: n bytes; probe_ok: one byte; ctl: the table's two control words,
// 0 between calls; probe_stats: two zeroed 64-bit words (longest chain,
// slots read), or null.  epoch >= 1, distinct per call on one table,
// increasing.  Calls on one table must not overlap.
extern "C" int sr_insert_claim(unsigned long long* slots, uint64_t capacity,
                               const uint32_t* hi, const uint32_t* lo,
                               const uint8_t* active, int64_t n,
                               uint32_t epoch, uint32_t* slot_out,
                               uint8_t* is_new, uint8_t* probe_ok,
                               unsigned* ctl, unsigned long long* probe_stats,
                               cudaStream_t stream) {
  return launch(slots, capacity, hi, lo, active, n, epoch, nullptr, slot_out,
                is_new, probe_ok, ctl, probe_stats, stream);
}

// The device-epoch entry: as sr_insert_claim, with the epoch the word at
// `epoch` plus one, written back at the call's end (the caller keeps the
// word below 0xFFFFFFFF and clears the tags when it wraps).
extern "C" int sr_insert_claim_dev(unsigned long long* slots,
                                   uint64_t capacity, const uint32_t* hi,
                                   const uint32_t* lo, const uint8_t* active,
                                   int64_t n, uint32_t* epoch,
                                   uint32_t* slot_out, uint8_t* is_new,
                                   uint8_t* probe_ok, unsigned* ctl,
                                   unsigned long long* probe_stats,
                                   cudaStream_t stream) {
  return launch(slots, capacity, hi, lo, active, n, 0u, epoch, slot_out,
                is_new, probe_ok, ctl, probe_stats, stream);
}
