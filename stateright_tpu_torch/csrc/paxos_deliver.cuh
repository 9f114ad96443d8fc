// The Deliver lane of slot k of the paxos row ``row`` (the JAX
// _deliver_lane, stateright_tpu/models/paxos_compiled.py:638): reads the
// row, runs the destination's handler (the 9-way message dispatch of
// PaxosActor / RegisterClient over the packed record), removes the
// delivered envelope from the slots, inserts up to three sends, and writes
// the successor row to ``out`` (W words).  ``valid`` is the lane's
// validity; the return value is its flag: a send past the M slots, or a
// branch the packed layout cannot hold (a round past 15, a Get on an
// undecided value, a missing proposal).
//
// The slot re-sort is a merge, because a row's slots are already sorted
// (nonzero codes ascending, then zeros): the remaining slots (slot k
// skipped, read from the row by a moving index) merge with the three
// sends, sorted by a three-element network, in unsigned order with empty
// slots as 0xFFFFFFFF -- compared unsigned, so the sentinel sorts last.
// The merge holds no slot in registers (each output slot is written as it
// is chosen), so 64 slots cost no more registers than 32.
#pragma once

#include "paxos_common.cuh"
#include "register_client.cuh"

namespace paxos {

__device__ __forceinline__ uint32_t sentinel(uint32_t code) {
  return code == 0u ? ONES : code;
}

__device__ __forceinline__ void sort3(uint32_t& a, uint32_t& b, uint32_t& c) {
  uint32_t t;
  if (b < a) { t = a; a = b; b = t; }
  if (c < b) { t = b; b = c; c = t; }
  if (b < a) { t = a; a = b; b = t; }
}

template <int C>
__device__ __forceinline__ bool deliver_lane(const uint32_t* __restrict__ row,
                                             int k, uint32_t* __restrict__ out,
                                             bool& valid) {
  using G = Geom<C>;
  uint32_t srv[2 * S];
#pragma unroll
  for (int i = 0; i < 2 * S; ++i) srv[i] = row[i];
  const uint32_t cli = row[CLI];
  uint32_t tst[C];
#pragma unroll
  for (int i = 0; i < C; ++i) tst[i] = row[G::TST0 + i];
  const uint32_t code = row[NET0 + k];
  const uint32_t prev = k == 0 ? 0u : row[NET0 + k - 1];
  const Lane l = decode_lane(code, srv);
  valid = occupied(code, prev, k) && guard<C>(l, cli);

  const uint32_t lo = l.lo, hi = l.hi, dsrv = l.dsrv, addr = l.addr;
  const uint32_t payload = l.payload, i_src = l.i_src, i_dst = l.i_dst;
  const uint32_t ballot = ext(lo, hi, F_BALLOT, W_BALLOT);
  const uint32_t prop = ext(lo, hi, F_PROP, G::W_PROP);
  const uint32_t accepted = ext(lo, hi, G::F_ACCEPTED, ACC_BITS);
  const bool decided = ext(lo, hi, G::F_DECIDED, 1) == 1u;
  const uint32_t p1 = (dsrv + 1u) % 3u, p2 = (dsrv + 2u) % 3u;

  uint32_t nlo = lo, nhi = hi;  // the destination server's new record
  uint32_t ncli = cli;
  uint32_t ci = i_dst < C - 1 ? i_dst : C - 1;  // clamped client index
  uint32_t ntw = 0;
#pragma unroll
  for (int i = 0; i < C; ++i) ntw = ci == static_cast<uint32_t>(i) ? tst[i] : ntw;
  uint32_t s0 = 0, s1 = 0, s2 = 0;
  bool branch_flag = false;

  switch (l.tag) {
    case T_PUT: {  // become leader of round r + 1, broadcast Prepare
      const uint32_t r_new = ballot / 3u + 1u;
      branch_flag = !decided && prop == 0u && r_new > MAX_ROUND;
      ins(nlo, nhi, F_BALLOT, W_BALLOT, r_new * 3u + dsrv);
      ins(nlo, nhi, F_PROP, G::W_PROP, addr + 1u);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool self = dsrv == static_cast<uint32_t>(s);
        ins(nlo, nhi, G::PREP0 + PW * s, 1, self ? 1u : 0u);
        ins(nlo, nhi, G::PREP0 + 1 + PW * s, ACC_BITS, self ? accepted : 0u);
        ins(nlo, nhi, G::F_ACCEPTS + s, 1, 0u);
      }
      s0 = mk(T_PREPARE, dsrv * 8u + p1, r_new);
      s1 = mk(T_PREPARE, dsrv * 8u + p2, r_new);
      break;
    }
    case T_GET: {  // a decided server answers with the chosen value
      branch_flag = decided && accepted == 0u;
      s0 = mk(T_GETOK, dsrv * 8u + addr, 1u + (accepted - 1u) % C);
      break;
    }
    case T_PREPARE: {
      ins(nlo, nhi, F_BALLOT, W_BALLOT, payload * 3u + i_src);
      s0 = mk(T_PREPARED, i_dst * 8u + i_src, payload * 512u + accepted);
      break;
    }
    case T_PREPARED: {
      const bool guard_ok = !decided && (payload / 512u) * 3u + i_dst == ballot;
      const uint32_t pd_acc = payload % 512u;
      uint32_t count_p = 0, best = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool from = i_src == static_cast<uint32_t>(s);
        const uint32_t pp = ext(lo, hi, G::PREP0 + PW * s, 1) | (from ? 1u : 0u);
        const uint32_t pa =
            from ? pd_acc : ext(lo, hi, G::PREP0 + 1 + PW * s, ACC_BITS);
        ins(nlo, nhi, G::PREP0 + PW * s, 1, pp);
        ins(nlo, nhi, G::PREP0 + 1 + PW * s, ACC_BITS, pa);
        count_p += pp;
        const uint32_t cand = pp == 1u ? pa : 0u;
        best = cand > best ? cand : best;
      }
      const bool trigger = count_p == 2u;  // majority(3)
      const uint32_t pd_prop = best > 0u ? 1u + (best - 1u) % C : prop;
      branch_flag = guard_ok && trigger && pd_prop == 0u;
      if (trigger) {  // adopt the proposal, self-accept, broadcast Accept
        ins(nlo, nhi, F_PROP, G::W_PROP, pd_prop);
        ins(nlo, nhi, G::F_ACCEPTED, ACC_BITS, 1u + ballot * C + (pd_prop - 1u));
#pragma unroll
        for (int s = 0; s < S; ++s)
          ins(nlo, nhi, G::F_ACCEPTS + s, 1, i_dst == static_cast<uint32_t>(s));
        const uint32_t pay = (ballot / 3u) * 8u + (pd_prop - 1u);
        s0 = mk(T_ACCEPT, i_dst * 8u + p1, pay);
        s1 = mk(T_ACCEPT, i_dst * 8u + p2, pay);
      }
      break;
    }
    case T_ACCEPT: {
      const uint32_t mb = (payload / 8u) * 3u + i_src;
      ins(nlo, nhi, F_BALLOT, W_BALLOT, mb);
      ins(nlo, nhi, G::F_ACCEPTED, ACC_BITS, 1u + mb * C + payload % 8u);
      s0 = mk(T_ACCEPTED, i_dst * 8u + i_src, payload / 8u);
      break;
    }
    case T_ACCEPTED: {
      const bool guard_ok = !decided && payload * 3u + i_dst == ballot;
      uint32_t count_a = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const uint32_t bit = ext(lo, hi, G::F_ACCEPTS + s, 1) |
                             (i_src == static_cast<uint32_t>(s) ? 1u : 0u);
        ins(nlo, nhi, G::F_ACCEPTS + s, 1, bit);
        count_a += bit;
      }
      const bool trigger = count_a == 2u;
      branch_flag = guard_ok && trigger && prop == 0u;
      ins(nlo, nhi, G::F_DECIDED, 1, trigger ? 1u : 0u);
      if (trigger) {  // broadcast Decided, answer the requester
        const uint32_t pay = ballot * 8u + (prop - 1u);
        s0 = mk(T_DECIDED, i_dst * 8u + p1, pay);
        s1 = mk(T_DECIDED, i_dst * 8u + p2, pay);
        s2 = mk(T_PUTOK, i_dst * 8u + (prop - 1u), 0u);
      }
      break;
    }
    case T_DECIDED: {
      ins(nlo, nhi, F_BALLOT, W_BALLOT, payload / 8u);
      ins(nlo, nhi, G::F_ACCEPTED, ACC_BITS,
          1u + (payload / 8u) * C + payload % 8u);
      ins(nlo, nhi, G::F_DECIDED, 1, 1u);
      break;
    }
    case T_PUTOK:  // client ci: (put, 1) -> (get, 2); tester 1 -> 3
      regcli::putok<C, 0>(tst, cli, ntw, ci, ncli, ntw);
      s0 = mk(T_GET, ci, 0u);
      break;
    case T_GETOK:  // client ci: (get, 2) -> (done, 3); tester 3 -> 4
      regcli::getok<C>(cli, ntw, ci, payload, ncli, ntw);
      break;
    default:
      break;
  }
  if (!valid) s0 = s1 = s2 = 0;  // no phantom sends from invalid lanes

  // Slots: merge the remaining slots (slot k removed) with the sorted
  // sends; empty slots are 0xFFFFFFFF so they sort last, unsigned.
  uint32_t a = sentinel(s0), b = sentinel(s1), c = sentinel(s2);
  sort3(a, b, c);
  int ri = 0;  // next remaining slot, counting past slot k
  int si = 0;  // next send
#pragma unroll
  for (int p = 0; p < G::M; ++p) {
    const int q = ri + (ri >= k ? 1 : 0);
    const uint32_t rv = q < G::M ? sentinel(row[NET0 + q]) : ONES;
    const uint32_t sv = si == 0 ? a : si == 1 ? b : si == 2 ? c : ONES;
    uint32_t x;
    if (rv <= sv) { x = rv; ++ri; } else { x = sv; ++si; }
    out[NET0 + p] = x == ONES ? 0u : x;
  }
  const int q = ri + (ri >= k ? 1 : 0);
  const uint32_t rv = q < G::M ? sentinel(row[NET0 + q]) : ONES;
  const uint32_t sv = si == 0 ? a : si == 1 ? b : si == 2 ? c : ONES;
  const bool slot_overflow = valid && (rv != ONES || sv != ONES);

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool mine = dsrv == static_cast<uint32_t>(s);
    out[2 * s] = mine ? nlo : srv[2 * s];
    out[2 * s + 1] = mine ? nhi : srv[2 * s + 1];
  }
  out[CLI] = ncli;
#pragma unroll
  for (int i = 0; i < C; ++i)
    out[G::TST0 + i] = ci == static_cast<uint32_t>(i) ? ntw : tst[i];
  return (branch_flag && valid) || slot_overflow;
}

}  // namespace paxos
