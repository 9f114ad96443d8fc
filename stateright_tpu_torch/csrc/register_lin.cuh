// Exact linearizability of a register-harness history: the device DP of
// stateright_tpu/models/register_compiled_common.py:273 device_linearizable,
// for 1..7 clients (the harness cap).  Shared by every register-harness
// model (paxos K6, single-copy K9), so it lives in a header.
//
// The host property runs LinearizabilityTester.serialized_history(), an
// exponential interleaving search.  Here the same decision is a
// reachability DP over Wing&Gong-style configurations: subsets of the 2C
// register operations (op i = client i's write, op C+i its read) crossed
// with the register value (0 = NULL, 1+i = client i's value).  An op may
// be appended iff its real-time prerequisites (from the tester's
// last-completed snapshots) are in the subset and, for a read, the
// register holds the value it returned.  The history is linearizable iff a
// configuration holding every completed op is reachable.
//
// The subset axis is bit-packed (bit k of word w = subset 32w + k), so the
// DP state is NV x NW u32 words: 4 x 2 at C = 3, 5 x 8 at C = 4, 7 x 128 at
// C = 6, 8 x 512 at C = 7.  Appending op o maps subset sub^bit(o) to sub:
// an in-word shift by 2^o for o < 5, a move by 2^(o-5) words for o >= 5.
// The real-time gate of op o is a superset indicator, the AND of static
// has-bit masks; it splits into an in-word mask (the ops below 5) and a
// test of the word index (the ops from 5 up), so it is computed per word
// on the fly and never stored.
//
// Bound: operations.  A round is 2C op sweeps over the NV x NW words.  The
// JAX DP runs a fixed 2C rounds; this one stops after the first round that
// adds no configuration (every later round would add none either, so the
// answer is the same bit for bit) and never runs more than 2C.
//
// Layout: a group of L threads holds one state's DP, thread r of it the
// words r*K .. r*K + K-1 of every value column (K = NW / L).  L = 1 up to
// C = 4 (40 words in one thread's registers); L = 32, a warp, from C = 5
// (K = 1, 4, 16 words a column at C = 5, 6, 7), where one thread's
// registers no longer hold the DP.  A word move by s >= K words is then a
// __shfl_up_sync by s / K lanes, the fixpoint test and the final cover
// test an __any_sync.  Only the column an op reads or writes is shifted:
// a write's source is the OR of all columns (the register may hold any
// value), a read's the column of the value it returned, selected by a mask
// and never by a runtime index, which would move the DP to local memory.
// At C = 7 a thread's 8 x 16 DP words and its row reach the 255-register
// cap: ptxas spills 72-80 bytes there (C = 7 is on no benchmarked path).
//
// Tester word of client i (C clients, LCB = 2(C-1), VB = max(2,
// bit_length(C))): phase (3 bits) | write-invocation snapshot (LCB) |
// read-invocation snapshot (LCB) | read value (VB); a snapshot holds 2 bits
// per other client (0 = nothing completed, else completed-op count).
#pragma once

#include <cstdint>

namespace reglin {

constexpr int bit_length(int x) { return x == 0 ? 0 : 1 + bit_length(x >> 1); }

template <int C>
struct Dims {
  static_assert(C >= 1 && C <= 7, "the register harness takes 1..7 clients");
  static constexpr int NOPS = 2 * C;
  static constexpr int NV = C + 1;
  static constexpr int NSUB = 1 << NOPS;
  static constexpr int NW = NSUB >= 32 ? NSUB / 32 : 1;
  static constexpr int LCB = 2 * (C - 1);
  static constexpr int VB = bit_length(C) > 2 ? bit_length(C) : 2;
  // Threads a state: one up to C = 4, a warp from C = 5.
  static constexpr int L = C <= 4 ? 1 : 32;
  static constexpr int K = NW / L;  // words of a column a thread holds
  static_assert(K >= 1 && K * L == NW, "the DP's words split evenly");
};

// HAS(b) for b < 5: bit k of a word is set iff subset bit b of k is set;
// only real subsets get bits.
template <int NSUB>
__device__ __forceinline__ uint32_t has_low(int b) {
  uint32_t m = b == 0   ? 0xAAAAAAAAu
               : b == 1 ? 0xCCCCCCCCu
               : b == 2 ? 0xF0F0F0F0u
               : b == 3 ? 0xFF00FF00u
                        : 0xFFFF0000u;
  if constexpr (NSUB < 32) m &= (1u << NSUB) - 1u;
  return m;
}

// The superset indicator {sub : mask ⊆ sub}, split: word w holds
// lo_of(mask) if (w & hi_of(mask)) == hi_of(mask), else 0.
template <int NSUB>
__device__ __forceinline__ uint32_t lo_of(uint32_t mask) {
  uint32_t x = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 5; ++b)
    if ((mask >> b) & 1u) x &= has_low<NSUB>(b);
  return x;
}

__device__ __forceinline__ uint32_t gated(uint32_t w, uint32_t lo,
                                          uint32_t hi) {
  return (w & hi) == hi ? lo : 0u;
}

template <int L>
__device__ __forceinline__ bool group_any(bool x) {
  if constexpr (L == 1) {
    return x;
  } else {
    return __any_sync(0xFFFFFFFFu, x);
  }
}

// tw: the C tester words of one state; r: this thread's rank in its group
// of Dims<C>::L threads (all of which call this with the same words).
// Returns the same answer in every thread of the group.
template <int C>
__device__ __forceinline__ bool linearizable(const uint32_t (&tw)[C], int r) {
  using D = Dims<C>;
  constexpr int K = D::K;
  // Per client, as bits of a word (registers are what the DP is short
  // of at C = 7): write completed, write present, read completed; and the
  // read values, VB bits each.
  uint32_t w_completed = 0u, w_present = 0u, r_present = 0u, v_read = 0u;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint32_t phase = tw[i] & 7u;
    w_completed |= static_cast<uint32_t>(phase >= 2u) << i;
    w_present |= static_cast<uint32_t>(phase >= 1u) << i;
    r_present |= static_cast<uint32_t>(phase == 4u) << i;  // completed reads
    v_read |= ((tw[i] >> (3 + 2 * D::LCB)) & ((1u << D::VB) - 1u)) << (D::VB * i);
  }
  // Real-time prerequisites of the reads: the own write and the ops the
  // snapshot saw completed.  Writes invoke at init: no prerequisite.
  uint32_t pm_read[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint32_t lc_r = (tw[i] >> (3 + D::LCB)) & ((1u << D::LCB) - 1u);
    uint32_t mask = 1u << i;
    int slot = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j == i) continue;
      const uint32_t cj = (lc_r >> (2 * slot)) & 3u;
      if (cj >= 1u && ((w_completed >> j) & 1u)) mask |= 1u << j;
      if (cj >= 2u && ((r_present >> j) & 1u)) mask |= 1u << (C + j);
      ++slot;
    }
    pm_read[i] = mask;
  }

  // dp[v][k]: word r*K + k of value column v.
  uint32_t dp[D::NV][K];
#pragma unroll
  for (int v = 0; v < D::NV; ++v)
#pragma unroll
    for (int k = 0; k < K; ++k) dp[v][k] = 0u;
  if (r == 0) dp[0][0] = 1u;  // the empty subset, register NULL
  const uint32_t w0 = static_cast<uint32_t>(r) * K;

  for (int round = 0; round < D::NOPS; ++round) {
    uint32_t grew = 0u;
#pragma unroll
    for (int o = 0; o < D::NOPS; ++o) {
      const bool write = o < C;
      const int i = write ? o : o - C;
      if ((((write ? w_present : r_present) >> i) & 1u) == 0u)
        continue;  // its gate is empty (uniform in the group)
      const uint32_t vr = (v_read >> (D::VB * i)) & ((1u << D::VB) - 1u);
      const uint32_t pm = write ? 0u : pm_read[i];
      // The gate superset(pm) & HAS(o), split as above.
      const uint32_t lo =
          lo_of<D::NSUB>(pm) & (o < 5 ? has_low<D::NSUB>(o < 5 ? o : 0) : ~0u);
      const uint32_t hi = (pm >> 5) | (o >= 5 ? 1u << (o >= 5 ? o - 5 : 0) : 0u);
      // The source column: any value for a write, the value read for a
      // read (a mask per column).
      uint32_t src[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t x = 0u;
#pragma unroll
        for (int v = 0; v < D::NV; ++v)
          x |= write ? dp[v][k]
                     : dp[v][k] & (0u - static_cast<uint32_t>(
                                            static_cast<uint32_t>(v) == vr));
        src[k] = x;
      }
      // Shift in place: subset sub^bit(o) -> sub.  Words without bit o
      // read anything; the gate clears them.  Within a thread the words
      // move up, so the loop runs down; across threads it is a shuffle.
      uint32_t (&add)[K] = src;
      if (o < 5) {
#pragma unroll
        for (int k = 0; k < K; ++k) add[k] <<= 1 << (o < 5 ? o : 0);
      } else {
        const int s = 1 << (o >= 5 ? o - 5 : 0);  // words
        if (s < K) {
#pragma unroll
          for (int k = K - 1; k >= 0; --k) add[k] = (k & s) ? src[k - s] : 0u;
        } else {
          if constexpr (D::L > 1) {
#pragma unroll
            for (int k = 0; k < K; ++k)
              add[k] = __shfl_up_sync(0xFFFFFFFFu, src[k], s / K);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) add[k] &= gated(w0 + k, lo, hi);
      if (write) {
#pragma unroll
        for (int v = 1; v < D::NV; ++v) {
          if (v != 1 + o) continue;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            grew |= add[k] & ~dp[v][k];
            dp[v][k] |= add[k];
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < D::NV; ++v) {
          const uint32_t hit =
              0u - static_cast<uint32_t>(static_cast<uint32_t>(v) == vr);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            grew |= add[k] & hit & ~dp[v][k];
            dp[v][k] |= add[k] & hit;
          }
        }
      }
    }
    if (!group_any<D::L>(grew != 0u)) break;  // the fixpoint
  }

  const uint32_t req = w_completed | (r_present << C);
  const uint32_t req_lo = lo_of<D::NSUB>(req), req_hi = req >> 5;
  bool any = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t cov = gated(w0 + k, req_lo, req_hi);
#pragma unroll
    for (int v = 0; v < D::NV; ++v) any |= (dp[v][k] & cov) != 0u;
  }
  return group_any<D::L>(any);
}

}  // namespace reglin
