// The register harness's client side on the card: the transitions of
// stateright_tpu/models/register_compiled_common.py putok_transition and
// getok_transition, shared by the register kernels that build successors
// (paxos K7, single-copy K9, ABD K10).
//
// Client word: a nibble per client, awaiting kind (0 none / 1 put / 2 get)
// | op count << 2.  Tester word of client i (C clients, LCB = 2(C-1)):
// phase (3 bits) | write-invocation snapshot (LCB) | read-invocation
// snapshot (LCB) | read value; a snapshot holds 2 bits per other client,
// the count of its completed operations.
#pragma once

#include <cstdint>

namespace regcli {

// Client ci (clamped below C) receives its PutOk: its nibble becomes (get,
// op count 2); its tester word goes from phase 1 to 3, snapshotting the
// other clients' completed operations at the Get's invocation.  row: words
// holding the C tester words from TST0 (static indices only, so a row in
// registers stays there).
template <int C, int TST0, int W>
__device__ __forceinline__ void putok(const uint32_t (&row)[W], uint32_t cli,
                                      uint32_t tw, uint32_t ci, uint32_t& ncli,
                                      uint32_t& ntw) {
  constexpr int LCB = 2 * (C - 1);
  ncli = (cli & ~(0xFu << (4u * ci))) | (10u << (4u * ci));
  uint32_t lc_r = 0u;
  int slot = 0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (static_cast<uint32_t>(j) == ci) continue;
    const uint32_t ph = row[TST0 + j] & 7u;
    const uint32_t cnt = (ph >= 2u ? 1u : 0u) + (ph == 4u ? 1u : 0u);
    lc_r |= cnt << (2 * slot);
    ++slot;
  }
  const uint32_t lc_w = (tw >> 3) & ((1u << LCB) - 1u);
  ntw = 3u | (lc_w << 3) | (lc_r << (3 + LCB));
}

// Client ci receives its GetOk(value): its nibble becomes (done, 3); its
// tester word goes from phase 3 to 4 with the value read (shifted in u32:
// a code too wide for its field leaves the word's top, as in JAX).
template <int C>
__device__ __forceinline__ void getok(uint32_t cli, uint32_t tw, uint32_t ci,
                                      uint32_t value_code, uint32_t& ncli,
                                      uint32_t& ntw) {
  constexpr int LCB = 2 * (C - 1);
  ncli = (cli & ~(0xFu << (4u * ci))) | (12u << (4u * ci));
  ntw = (tw & ~7u) | 4u | (value_code << (3 + 2 * LCB));
}

}  // namespace regcli
