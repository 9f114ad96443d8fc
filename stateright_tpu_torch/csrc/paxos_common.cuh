// Shared device helpers of the paxos kernels (K5 paxos_valid.cu, K6
// paxos_conds.cu, K7 paxos_lane.cu): the packed layout of
// stateright_tpu/models/paxos_compiled.py, its field accessors and the
// Deliver-lane guards.  Everything is uint32_t arithmetic, so the JAX code's
// wrap-around (code - 1 on an empty slot, k - 1 at k = 0, accepted - 1 at
// accepted 0, prop - 1 on the flagged branches) happens here as it does
// there.
//
// Row layout (C clients, M = 16 slots for C <= 2, 32 for C = 3, 64 from
// C = 4, W words):
//   words 0..5   three server records, (lo, hi) each: ballot code (6 bits,
//                round*3 + leader) | proposal (PB = max(2, bit_length(C))
//                bits) | 3 prepare entries (present bit + 9-bit accepted
//                code) | 3 accept bits | accepted (9) | decided (1), so the
//                fields after the proposal move up a bit from C = 4;
//   word 6       client nibbles: awaiting kind (2 bits) + op count (2);
//   words 7..    M network slots: sorted nonzero envelope codes, then 0;
//   last C       tester words.
// Envelope code = 1 + (tag << 19 | addr << 14 | payload).
#pragma once

#include "sr_common.cuh"

namespace paxos {

constexpr int S = 3;
constexpr uint32_t MAX_ROUND = 15;
constexpr uint32_t ONES = 0xFFFFFFFFu;

constexpr uint32_t T_PUT = 0, T_GET = 1, T_PUTOK = 2, T_GETOK = 3,
                   T_PREPARE = 4, T_PREPARED = 5, T_ACCEPT = 6,
                   T_ACCEPTED = 7, T_DECIDED = 8;

// Accepted codes are 1 + ballot_code*C + proposal_idx <= 1 + 47*7 + 6 < 2**9.
constexpr int ACC_BITS = 9;
constexpr int F_BALLOT = 0, W_BALLOT = 6;
constexpr int F_PROP = 6;
constexpr int PW = 1 + ACC_BITS;  // one prepare entry
constexpr int CLI = 2 * S;
constexpr int NET0 = 2 * S + 1;

// The layout at C clients; models/paxos_compiled.py's paxos_fields mirrors
// the server-record offsets.
template <int C>
struct Geom {
  static_assert(C >= 1 && C <= 7, "packed paxos takes 1..7 clients");
  static constexpr int M = C <= 2 ? 16 : C == 3 ? 32 : 64;  // slots = lanes
  static constexpr int TST0 = NET0 + M;    // first tester word
  static constexpr int W = TST0 + C;       // words a row
  // Server-record fields after the proposal, whose width follows C.
  static constexpr int W_PROP = C >= 4 ? 3 : 2;  // max(2, bit_length(C))
  static constexpr int PREP0 = F_PROP + W_PROP;
  static constexpr int F_ACCEPTS = PREP0 + S * PW;
  static constexpr int F_ACCEPTED = F_ACCEPTS + S;
  static constexpr int F_DECIDED = F_ACCEPTED + ACC_BITS;
};

// A static bit field of a (lo, hi) pair (the JAX _ext).
__device__ __forceinline__ uint32_t ext(uint32_t lo, uint32_t hi, int off,
                                        int width) {
  const uint32_t mask = (1u << width) - 1u;
  if (off + width <= 32) return (lo >> off) & mask;
  if (off >= 32) return (hi >> (off - 32)) & mask;
  return ((lo >> off) | (hi << (32 - off))) & mask;
}

// Insert val into a (lo, hi) pair exactly as the JAX _ins does: unmasked,
// so an over-wide value spills as it does there.
__device__ __forceinline__ void ins(uint32_t& lo, uint32_t& hi, int off,
                                    int width, uint32_t val) {
  const uint32_t m = (1u << width) - 1u;
  if (off + width <= 32) {
    lo = (lo & ~(m << off)) | (val << off);
  } else if (off >= 32) {
    const int o = off - 32;
    hi = (hi & ~(m << o)) | (val << o);
  } else {
    const int nlo = 32 - off;
    const uint32_t low = (1u << nlo) - 1u;
    lo = (lo & ~((m & low) << off)) | ((val & low) << off);
    hi = (hi & ~(m >> nlo)) | (val >> nlo);
  }
}

__device__ __forceinline__ uint32_t mk(uint32_t tag, uint32_t addr,
                                       uint32_t payload) {
  return 1u + ((tag << 19) | (addr << 14) | payload);
}

// The fields of one Deliver lane: its envelope and the destination server's
// record, chosen by a select over the three records (0, 0 for an
// out-of-range server index, as in JAX).
struct Lane {
  uint32_t tag, addr, payload, i_src, i_dst, dsrv, lo, hi;
};

__device__ __forceinline__ Lane decode_lane(uint32_t code, const uint32_t* srv) {
  Lane l;
  const uint32_t e = code - 1u;  // wraps to all-ones on an empty slot
  l.tag = e >> 19;
  l.addr = (e >> 14) & 0x1Fu;
  l.payload = e & 0x3FFFu;
  l.i_src = l.addr >> 3;
  l.i_dst = l.addr & 7u;
  l.dsrv = l.tag == T_PUT ? l.addr % 3u
           : l.tag == T_GET ? (l.addr + 1u) % 3u
                            : l.i_dst;
  l.lo = l.dsrv == 0 ? srv[0] : l.dsrv == 1 ? srv[2] : l.dsrv == 2 ? srv[4] : 0u;
  l.hi = l.dsrv == 0 ? srv[1] : l.dsrv == 1 ? srv[3] : l.dsrv == 2 ? srv[5] : 0u;
  return l;
}

// Client ci's awaiting kind, ci clamped to C - 1 (the JAX client_record).
template <int C>
__device__ __forceinline__ uint32_t client_kind(uint32_t cli, uint32_t ci) {
  ci = ci < C - 1 ? ci : C - 1;
  return (cli >> (4u * ci)) & 3u;
}

// The 9-way guard per tag, before occupancy (the JAX step_valid).
template <int C>
__device__ __forceinline__ bool guard(const Lane& l, uint32_t cli) {
  using G = Geom<C>;
  const uint32_t ballot = ext(l.lo, l.hi, F_BALLOT, W_BALLOT);
  const uint32_t prop = ext(l.lo, l.hi, F_PROP, G::W_PROP);
  const bool decided = ext(l.lo, l.hi, G::F_DECIDED, 1) == 1u;
  const uint32_t p = l.payload;
  switch (l.tag) {
    case T_PUT: return !decided && prop == 0u;
    case T_GET: return decided;
    case T_PREPARE: return !decided && ballot < p * 3u + l.i_src;
    case T_PREPARED: return !decided && (p / 512u) * 3u + l.i_dst == ballot;
    case T_ACCEPT: return !decided && ballot <= (p / 8u) * 3u + l.i_src;
    case T_ACCEPTED: return !decided && p * 3u + l.i_dst == ballot;
    case T_DECIDED: return !decided;
    case T_PUTOK: return client_kind<C>(cli, l.i_dst) == 1u && l.i_dst < C;
    case T_GETOK: return client_kind<C>(cli, l.i_dst) == 2u && l.i_dst < C;
    default: return false;
  }
}

// Only the first slot of a run of equal codes is a lane: later copies of a
// duplicated send stay in flight (the JAX representative_slot_code, where
// the slot before k = 0 reads as 0).
__device__ __forceinline__ bool occupied(uint32_t code, uint32_t prev, int k) {
  return code != 0u && (k == 0 || prev != code);
}

// Launch one kernel instantiation per client count.
#define PAXOS_DISPATCH(c, CALL) \
  switch (c) {                  \
    case 1: { CALL(1); break; } \
    case 2: { CALL(2); break; } \
    case 3: { CALL(3); break; } \
    case 4: { CALL(4); break; } \
    case 5: { CALL(5); break; } \
    case 6: { CALL(6); break; } \
    case 7: { CALL(7); break; } \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace paxos
