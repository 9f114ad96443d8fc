// Exact linearizability of a register-harness history, one state per
// thread: the device DP of
// stateright_tpu/models/register_compiled_common.py:273 device_linearizable.
// Shared by every register-harness model (paxos now; ABD and single-copy
// later), so it lives in a header.
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
// DP state is NV x NW u32 words -- 4 x 2 at C = 3 -- and lives in
// registers; every transition is word-parallel: appending op o maps subset
// sub^bit(o) to sub, an in-word shift by 2^o for o < 5 and a word move for
// o >= 5.  The real-time gate is a superset indicator, the AND of static
// has-bit masks.  2C rounds of sweeps over the ops reach the fixpoint.
//
// Tester word of client i (C clients, LCB = 2(C-1)): phase (3 bits) |
// write-invocation snapshot (LCB) | read-invocation snapshot (LCB) | read
// value (2 bits); a snapshot holds 2 bits per other client (0 = nothing
// completed, else completed-op count).
#pragma once

#include <cstdint>

namespace reglin {

template <int C>
struct Dims {
  static_assert(C >= 1 && C <= 3, "registers hold the DP up to 3 clients");
  static constexpr int NOPS = 2 * C;
  static constexpr int NV = C + 1;
  static constexpr int NSUB = 1 << NOPS;
  static constexpr int NW = NSUB >= 32 ? NSUB / 32 : 1;
  static constexpr int LCB = 2 * (C - 1);
  static constexpr int VB = 2;  // max(2, bit_length(C)) for C <= 3
};

// HAS(b, w): bit k of word w is set iff subset 32w + k contains op b; only
// real subsets get bits.
template <int NSUB>
__device__ __forceinline__ uint32_t has(int b, int w) {
  uint32_t m = b == 0   ? 0xAAAAAAAAu
               : b == 1 ? 0xCCCCCCCCu
               : b == 2 ? 0xF0F0F0F0u
               : b == 3 ? 0xFF00FF00u
               : b == 4 ? 0xFFFF0000u
               : (((w >> (b - 5)) & 1) ? 0xFFFFFFFFu : 0u);
  if constexpr (NSUB < 32) m &= (1u << NSUB) - 1u;
  return m;
}

template <int C>
__device__ __forceinline__ void superset(uint32_t mask,
                                         uint32_t (&out)[Dims<C>::NW]) {
  using D = Dims<C>;
#pragma unroll
  for (int w = 0; w < D::NW; ++w) {
    uint32_t x = 0xFFFFFFFFu;
#pragma unroll
    for (int b = 0; b < D::NOPS; ++b)
      if ((mask >> b) & 1u) x &= has<D::NSUB>(b, w);
    out[w] = x;
  }
}

// tw: the C tester words of one state.  Inlined, so the caller's words and
// the DP stay in registers.
template <int C>
__device__ __forceinline__ bool linearizable(const uint32_t (&tw)[C]) {
  using D = Dims<C>;
  uint32_t lc_r[C], v_read[C];
  bool w_completed[C], present[D::NOPS], r_present[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const uint32_t phase = tw[i] & 7u;
    lc_r[i] = (tw[i] >> (3 + D::LCB)) & ((1u << D::LCB) - 1u);
    v_read[i] = (tw[i] >> (3 + 2 * D::LCB)) & ((1u << D::VB) - 1u);
    w_completed[i] = phase >= 2u;
    present[i] = phase >= 1u;
    r_present[i] = phase == 4u;  // completed reads
    present[C + i] = r_present[i];
  }
  // Real-time prerequisites: writes invoke at init (empty); a read needs
  // its own write and the ops its snapshot saw completed.
  uint32_t pm[D::NOPS];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    pm[i] = 0u;
    uint32_t mask = 1u << i;
    int slot = 0;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j == i) continue;
      const uint32_t cj = (lc_r[i] >> (2 * slot)) & 3u;
      if (cj >= 1u && w_completed[j]) mask |= 1u << j;
      if (cj >= 2u && r_present[j]) mask |= 1u << (C + j);
      ++slot;
    }
    pm[C + i] = mask;
  }
  uint32_t gate[D::NOPS][D::NW];
#pragma unroll
  for (int o = 0; o < D::NOPS; ++o) {
    superset<C>(pm[o], gate[o]);
#pragma unroll
    for (int w = 0; w < D::NW; ++w)
      gate[o][w] = present[o] ? gate[o][w] & has<D::NSUB>(o, w) : 0u;
  }

  uint32_t dp[D::NV][D::NW];
#pragma unroll
  for (int v = 0; v < D::NV; ++v)
#pragma unroll
    for (int w = 0; w < D::NW; ++w) dp[v][w] = 0u;
  dp[0][0] = 1u;  // the empty subset, register NULL

  for (int round = 0; round < D::NOPS; ++round) {
#pragma unroll
    for (int o = 0; o < D::NOPS; ++o) {
      uint32_t shifted[D::NV][D::NW];
#pragma unroll
      for (int v = 0; v < D::NV; ++v)
#pragma unroll
        for (int w = 0; w < D::NW; ++w) {
          if (o < 5) {
            shifted[v][w] =
                (dp[v][w] << (1 << (o < 5 ? o : 0))) & has<D::NSUB>(o, w);
          } else {
            const int bit = o < 5 ? 0 : o - 5;
            const int from = ((w >> bit) & 1) ? w - (1 << bit) : w;
            shifted[v][w] = ((w >> bit) & 1) ? dp[v][from] : 0u;
          }
        }
      if (o < C) {
        // Write: any source value reaches; the register becomes 1 + o.
#pragma unroll
        for (int w = 0; w < D::NW; ++w) {
          uint32_t any_v = 0u;
#pragma unroll
          for (int v = 0; v < D::NV; ++v) any_v |= shifted[v][w];
          dp[1 + o][w] |= any_v & gate[o][w];
        }
      } else {
        // Read: the register must already hold the value it returned.
        // A mask, not a branch: branches on v_read let the compiler merge
        // the NV stores into one at a runtime index, which moves dp and
        // shifted to local memory.
#pragma unroll
        for (int v = 0; v < D::NV; ++v) {
          const uint32_t hit =
              0u - static_cast<uint32_t>(static_cast<uint32_t>(v) == v_read[o - C]);
#pragma unroll
          for (int w = 0; w < D::NW; ++w)
            dp[v][w] |= shifted[v][w] & gate[o][w] & hit;
        }
      }
    }
  }

  uint32_t req = 0u;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (w_completed[i]) req |= 1u << i;
    if (r_present[i]) req |= 1u << (C + i);
  }
  uint32_t covers[D::NW];
  superset<C>(req, covers);
  bool any = false;
#pragma unroll
  for (int v = 0; v < D::NV; ++v)
#pragma unroll
    for (int w = 0; w < D::NW; ++w) any |= (dp[v][w] & covers[w]) != 0u;
  return any;
}

}  // namespace reglin
