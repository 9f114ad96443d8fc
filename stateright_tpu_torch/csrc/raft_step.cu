// K11: raft's successor step and property conditions, fused.
//
// Replaces stateright_tpu/models/raft_compiled.py:418 step with its lanes
// :520 _deliver_lane, :966 _election_lane, :1018 _replication_lane, :1046
// _crash_lane and :1072 _recover_lane, :1098 _assemble, and :1152
// property_conds.  Row layout (3 servers, W = 58 words):
//   words 0..5   a 56-bit node record a server over a lo/hi pair: term (3),
//                voted_for (2: 0 none, 1 + i), role (2), leader (2), votes
//                bitmap (3), commit (3), log_len (3), 4 log entries of term
//                (3) + payload (2), sent_length 3 x 3, acked_length 3 x 3;
//   word 6       timers (2 bits a node: election, replication) and the
//                crashed bitmap (bits 6..8);
//   words 7..54  24 envelope codes of two words, sorted by (w0, w1) with
//                the nonzero codes first, then zero pairs (the multiset: a
//                duplicate is a repeated code);
//   words 55..57 each node's delivered messages (count 3 bits, 5 payloads
//                of 2) and buffer (count 2 bits at 13, 3 payloads at 15).
// Envelope w0 = tag (3) | src (2) << 3 | dst (2) << 5 | fields a..e (3 bits
// each at 7, 10, 13, 16, 19); w1 = a LogRequest's suffix (5 bits an entry).
//
// Lane k < 24 delivers slot k (only the first of a run of equal codes is a
// lane; never to a crashed node).  Lanes 24 + 4i + {0, 1, 2, 3} are node
// i's election timeout, replication timeout, crash and recover.  Every
// lane's words are the JAX lane's, valid or not, u32 wrap-around included:
// a select at an index outside its list gives 0 (sel3/sel4, never arr[idx]),
// and field inserts are not masked to their width.  The successor's
// network is the row's slots without the delivered one, merged with the
// lane's sends: both are sorted, so each code's place is its rank, and the
// result is the JAX 29-key stable sort's (equal keys are equal words).
// A state's overflow byte is set by any of its valid lanes that flags: a
// term past TERM_CAP, a log past LOG_CAP, delivered messages past
// DELIV_CAP, a buffer past BUF_CAP, or more than 24 envelopes after the
// merge.  The
// conds (a state's lane 0 writes them): Election Liveness, Log Liveness,
// Election Safety, State Machine Safety.
//
// Bound: bytes (a 232-byte row in; 36 successor rows of 232 bytes, 36
// validity bytes and 4 cond bytes out; a few hundred integer operations a
// lane).  Design: one thread a (state, lane), so a wave of F states runs
// 36 F threads and fills the card; the 36 threads of a state read its row
// through L1.  A thread builds its lane in registers (every array index is
// static after unrolling) and writes its row word by word, the network
// words at their merged positions; the stores of a warp do not coalesce
// (rows 232 bytes apart).  A simple kernel first.
#include "sr_common.cuh"

namespace {

constexpr int N = 3;
constexpr uint32_t TERM_CAP = 7, LOG_CAP = 4, BUF_CAP = 3, DELIV_CAP = 5;
constexpr int NET_SLOTS = 24, SENDS = 5;
constexpr int NET0 = 2 * N + 1, NONFP0 = NET0 + 2 * NET_SLOTS;
constexpr int W = NONFP0 + N, A = NET_SLOTS + 4 * N;
constexpr uint32_t T_VOTE_REQ = 1, T_VOTE_RESP = 2, T_LOG_REQ = 3,
                   T_LOG_RESP = 4, T_BCAST = 5;
constexpr uint32_t FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
// Node-record field offsets (bits of the 56-bit lo/hi pair).
constexpr int F_TERM = 0, F_VOTED = 3, F_ROLE = 5, F_LEADER = 7, F_VOTES = 9,
              F_COMMIT = 12, F_LOGLEN = 15, LOG0 = 18, F_SENT0 = 38,
              F_ACKED0 = 47;

struct Rec {
  uint32_t lo, hi;
};

__device__ __forceinline__ uint32_t ext(Rec r, int off, int width) {
  const uint32_t mask = (1u << width) - 1u;
  if (off + width <= 32) return (r.lo >> off) & mask;
  if (off >= 32) return (r.hi >> (off - 32)) & mask;
  return ((r.lo >> off) | (r.hi << (32 - off))) & mask;
}

// The JAX _ins: shifted in u32, not masked to the width.
__device__ __forceinline__ Rec ins(Rec r, int off, int width, uint32_t val) {
  const uint32_t m = (1u << width) - 1u;
  if (off + width <= 32) {
    r.lo = (r.lo & ~(m << off)) | (val << off);
  } else if (off >= 32) {
    const int o = off - 32;
    r.hi = (r.hi & ~(m << o)) | (val << o);
  } else {
    const int nlo = 32 - off;
    const uint32_t low = (1u << nlo) - 1u;
    r.lo = (r.lo & ~((m & low) << off)) | ((val & low) << off);
    r.hi = (r.hi & ~(m >> nlo)) | (val >> nlo);
  }
  return r;
}

struct Fields {
  uint32_t term, voted, role, leader, commit, loglen;
  uint32_t votes[N], log[LOG_CAP], sent[N], acked[N];
};

__device__ __forceinline__ Fields fields(Rec r) {
  Fields f;
  f.term = ext(r, F_TERM, 3);
  f.voted = ext(r, F_VOTED, 2);
  f.role = ext(r, F_ROLE, 2);
  f.leader = ext(r, F_LEADER, 2);
  f.commit = ext(r, F_COMMIT, 3);
  f.loglen = ext(r, F_LOGLEN, 3);
#pragma unroll
  for (int v = 0; v < N; ++v) f.votes[v] = ext(r, F_VOTES + v, 1);
#pragma unroll
  for (int e = 0; e < (int)LOG_CAP; ++e) f.log[e] = ext(r, LOG0 + 5 * e, 5);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.sent[i] = ext(r, F_SENT0 + 3 * i, 3);
    f.acked[i] = ext(r, F_ACKED0 + 3 * i, 3);
  }
  return f;
}

// entries[idx], 0 for an index outside the list (a wrapped u32 included).
__device__ __forceinline__ uint32_t sel3(const uint32_t (&a)[N], uint32_t idx) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) out = idx == (uint32_t)e ? a[e] : out;
  return out;
}

__device__ __forceinline__ uint32_t sel4(const uint32_t (&a)[LOG_CAP], uint32_t idx) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < (int)LOG_CAP; ++e) out = idx == (uint32_t)e ? a[e] : out;
  return out;
}

__device__ __forceinline__ uint32_t last_term(const Fields& f) {
  return f.loglen == 0 ? 0u : sel4(f.log, f.loglen - 1u) & 7u;
}

// The replicate_log send (models/raft.py:308-322): LogRequest(me, term,
// sent[peer], the term of the entry before, commit, log[sent[peer]:]).
__device__ __forceinline__ void mk_logreq(uint32_t me, uint32_t peer,
                                          const Fields& f, uint32_t& w0,
                                          uint32_t& w1) {
  const uint32_t plen = sel3(f.sent, peer);
  const uint32_t pterm = plen == 0 ? 0u : sel4(f.log, plen - 1u) & 7u;
  const uint32_t slen = f.loglen - plen;
  w0 = T_LOG_REQ | (me << 3) | (peer << 5) | (f.term << 7) | (plen << 10) |
       (pterm << 13) | (f.commit << 16) | (slen << 19);
  w1 = 0;
#pragma unroll
  for (int j = 0; j < (int)LOG_CAP; ++j)
    if ((uint32_t)j < slen) w1 |= sel4(f.log, plen + j) << (5 * j);
}

// The two peers of node i, ascending.
__device__ __forceinline__ uint32_t peer1(uint32_t i) { return i == 0 ? 1u : 0u; }
__device__ __forceinline__ uint32_t peer2(uint32_t i) { return i == 2 ? 1u : 2u; }

// What a lane does to its parent row, before the merge.
struct Lane {
  uint32_t node;  // the node whose record, buffer word changes (3: none)
  Rec rec;
  uint32_t nonfp, tbits;
  int remove;  // the slot delivered, -1 for none
  uint32_t s0[SENDS], s1[SENDS];
  bool valid, flag, net_flag;
};

__device__ __forceinline__ Rec stepped_down(Rec r, uint32_t term) {
  r = ins(r, F_TERM, 3, term);
  r = ins(r, F_ROLE, 2, FOLLOWER);
  return ins(r, F_VOTED, 2, 0);
}

__device__ __forceinline__ void deliver_lane(const uint32_t* __restrict__ row, int k, Lane& L) {
  const uint32_t w0 = row[NET0 + 2 * k], w1 = row[NET0 + 2 * k + 1];
  const bool occupied = w0 != 0;
  const bool first =
      k == 0 || row[NET0 + 2 * k - 2] != w0 || row[NET0 + 2 * k - 1] != w1;
  const uint32_t tag = w0 & 7u, src = (w0 >> 3) & 3u, dst = (w0 >> 5) & 3u;
  const uint32_t a = (w0 >> 7) & 7u, b = (w0 >> 10) & 7u, c = (w0 >> 13) & 7u,
                 d = (w0 >> 16) & 7u, e = (w0 >> 19) & 7u;
  const uint32_t tbits = row[2 * N];
  const bool dst_crashed = (tbits >> (2 * N + dst)) & 1u;
  Rec node{0, 0};
  uint32_t nonfp = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (dst == (uint32_t)i) {
      node = Rec{row[2 * i], row[2 * i + 1]};
      nonfp = row[NONFP0 + i];
    }
  }
  const Fields f = fields(node);
  const uint32_t dlen = nonfp & 7u, blen = (nonfp >> 13) & 3u;
  const bool is_leader = f.role == LEADER;
  const bool no_leader = f.leader == 0;

  // The flag terms of every handler, whatever the tag (as JAX ORs them).
  // LogRequest: the appended log and the delivered messages.
  const uint32_t lr_term = a > f.term ? a : f.term;
  const bool lr_eq = a == lr_term;
  const bool prefix_ok = b == 0 || (sel4(f.log, b - 1u) & 7u) == c;
  const bool do_append = lr_eq && f.loglen >= b && prefix_ok;
  uint32_t suffix[LOG_CAP];
#pragma unroll
  for (int j = 0; j < (int)LOG_CAP; ++j) suffix[j] = (w1 >> (5 * j)) & 0x1Fu;
  const uint32_t idx = (f.loglen < b + e ? f.loglen : b + e) - 1u;
  const bool truncate = e > 0 && f.loglen > b &&
                        (sel4(f.log, idx) & 7u) != (sel4(suffix, idx - b) & 7u);
  const uint32_t base_len = truncate ? b : f.loglen;
  const uint32_t new_len = base_len > b + e ? base_len : b + e;
  const bool adv = do_append && d > f.commit;
  const uint32_t new_dlen = dlen + (adv ? d - f.commit : 0u);
  bool flag = (do_append && new_len > LOG_CAP) || new_dlen > DELIV_CAP;
  // LogResponse: the commit scan after sent[src] = acked[src] = ack.
  const bool upd = c == 1 && b >= sel3(f.acked, src);
  uint32_t up_acked[N];
#pragma unroll
  for (int i = 0; i < N; ++i) up_acked[i] = src == (uint32_t)i ? b : f.acked[i];
  uint32_t ready_max = 0;
#pragma unroll
  for (uint32_t i = 1; i <= LOG_CAP; ++i) {
    uint32_t cnt = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += up_acked[j] >= i;
    if (i > f.commit && i <= f.loglen && cnt >= 2) ready_max = i;
  }
  const bool do_commit =
      ready_max > 0 && (sel4(f.log, ready_max - 1u) & 7u) == f.term;
  const uint32_t new_dlen2 = dlen + (do_commit ? ready_max - f.commit : 0u);
  flag = flag || (upd && new_dlen2 > DELIV_CAP);
  // Broadcast: a leader's full log, a buffer with no room.
  const bool is_bcast = occupied && tag == T_BCAST;
  flag = flag || (is_bcast && is_leader && f.loglen >= LOG_CAP) ||
         (is_bcast && !is_leader && no_leader && blen >= BUF_CAP);

  L.node = dst;
  L.rec = node;
  L.nonfp = nonfp;
  L.remove = k;
#pragma unroll
  for (int j = 0; j < SENDS; ++j) L.s0[j] = L.s1[j] = 0;
  L.flag = flag;
  L.net_flag = true;
  bool tag_valid = false, set_e = false;

  switch (tag) {
    case T_VOTE_REQ: {  // models/raft.py:143-167
      const bool newer = a > f.term;
      const uint32_t term = newer ? a : f.term;
      const uint32_t role = newer ? FOLLOWER : f.role;
      const uint32_t voted = newer ? 0u : f.voted;
      const uint32_t lt = last_term(f);
      const bool log_ok = c > lt || (c == lt && b >= f.loglen);
      const bool granted = a == term && log_ok && (voted == 0 || voted == src + 1);
      Rec r = ins(node, F_TERM, 3, term);
      r = ins(r, F_ROLE, 2, role);
      L.rec = ins(r, F_VOTED, 2, granted ? src + 1 : voted);
      L.s0[0] = T_VOTE_RESP | (dst << 3) | (src << 5) | (term << 7) |
                ((uint32_t)granted << 10);
      tag_valid = true;
      break;
    }
    case T_VOTE_RESP: {  // models/raft.py:169-204
      const bool grant_path = f.role == CANDIDATE && a == f.term && b == 1;
      uint32_t votes2[N];
      uint32_t vcount = 0;
#pragma unroll
      for (int v = 0; v < N; ++v) {
        votes2[v] = src == (uint32_t)v ? 1u : f.votes[v];
        vcount += votes2[v];
      }
      const bool win = grant_path && vcount >= 2;
      Rec rs = node;
#pragma unroll
      for (int v = 0; v < N; ++v) rs = ins(rs, F_VOTES + v, 1, votes2[v]);
      L.rec = rs;
      if (win) {
        // Drain the buffer to self, take the lead, replicate.
#pragma unroll
        for (int j = 0; j < (int)BUF_CAP; ++j) {
          const uint32_t payload = (nonfp >> (15 + 2 * j)) & 3u;
          if ((uint32_t)j < blen)
            L.s0[j] = T_BCAST | (dst << 3) | (dst << 5) | (payload << 7);
        }
        L.nonfp = nonfp & ((1u << 13) - 1u);
        Rec w = ins(rs, F_ROLE, 2, LEADER);
        w = ins(w, F_LEADER, 2, dst + 1);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const bool is_peer = dst != (uint32_t)i;
          const uint32_t cur_sent = ext(w, F_SENT0 + 3 * i, 3);
          const uint32_t cur_acked = ext(w, F_ACKED0 + 3 * i, 3);
          w = ins(w, F_SENT0 + 3 * i, 3, is_peer ? f.loglen : cur_sent);
          w = ins(w, F_ACKED0 + 3 * i, 3, is_peer ? 0u : cur_acked);
        }
        const Fields wf = fields(w);
        mk_logreq(dst, peer1(dst), wf, L.s0[BUF_CAP], L.s1[BUF_CAP]);
        mk_logreq(dst, peer2(dst), wf, L.s0[BUF_CAP + 1], L.s1[BUF_CAP + 1]);
        L.rec = w;
      }
      const bool stale = !grant_path && a > f.term;
      if (stale) L.rec = stepped_down(node, a);
      tag_valid = grant_path || stale;
      set_e = stale;
      break;
    }
    case T_LOG_REQ: {  // models/raft.py:206-232
      const bool newer = a > f.term;
      Rec r = ins(node, F_TERM, 3, lr_term);
      r = ins(r, F_VOTED, 2, newer ? 0u : f.voted);
      r = ins(r, F_ROLE, 2, lr_eq ? FOLLOWER : f.role);
      r = ins(r, F_LEADER, 2, lr_eq ? src + 1 : f.leader);
      if (do_append) {
        // _append_entries (models/raft.py:324-341).
        uint32_t new_log[LOG_CAP];
#pragma unroll
        for (int p = 0; p < (int)LOG_CAP; ++p) {
          const bool from_suffix = (uint32_t)p >= base_len && (uint32_t)p < new_len;
          new_log[p] = (uint32_t)p < base_len
                           ? f.log[p]
                           : (from_suffix ? sel4(suffix, p - b) : 0u);
        }
        r = ins(r, F_LOGLEN, 3, new_len);
#pragma unroll
        for (int p = 0; p < (int)LOG_CAP; ++p) r = ins(r, LOG0 + 5 * p, 5, new_log[p]);
        r = ins(r, F_COMMIT, 3, adv ? d : f.commit);
        uint32_t nf = nonfp;
        if (adv) {
#pragma unroll
          for (int j = 0; j < (int)DELIV_CAP; ++j) {
            if ((uint32_t)j >= dlen && (uint32_t)j < new_dlen) {
              const uint32_t pay = (sel4(new_log, f.commit + j - dlen) >> 3) & 3u;
              nf = (nf & ~(3u << (3 + 2 * j))) | (pay << (3 + 2 * j));
            }
          }
          nf = (nf & ~7u) | new_dlen;
        }
        L.nonfp = nf;
      }
      L.rec = r;
      const uint32_t ack = do_append ? b + e : 0u;
      L.s0[0] = T_LOG_RESP | (dst << 3) | (src << 5) | (lr_term << 7) |
                (ack << 10) | ((uint32_t)do_append << 13);
      tag_valid = true;
      set_e = a > f.term || lr_eq;
      break;
    }
    case T_LOG_RESP: {  // models/raft.py:234-259
      const bool lead_path = a == f.term && f.role == LEADER;
      const uint32_t sent_src = sel3(f.sent, src);
      const bool retry = !upd && sent_src > 0;
      if (lead_path && upd) {
        Rec r = node;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const bool sel = src == (uint32_t)i;
          r = ins(r, F_SENT0 + 3 * i, 3, sel ? b : f.sent[i]);
          r = ins(r, F_ACKED0 + 3 * i, 3, sel ? b : f.acked[i]);
        }
        L.rec = ins(r, F_COMMIT, 3, do_commit ? ready_max : f.commit);
        if (do_commit) {
          uint32_t nf = nonfp;
#pragma unroll
          for (int j = 0; j < (int)DELIV_CAP; ++j) {
            if ((uint32_t)j >= dlen && (uint32_t)j < new_dlen2) {
              const uint32_t pay = (sel4(f.log, f.commit + j - dlen) >> 3) & 3u;
              nf = (nf & ~(3u << (3 + 2 * j))) | (pay << (3 + 2 * j));
            }
          }
          L.nonfp = (nf & ~7u) | new_dlen2;
        }
      } else if (lead_path && retry) {
        // sent[src] -= 1 and resend (models/raft.py:245-249).
        Rec r = node;
#pragma unroll
        for (int i = 0; i < N; ++i)
          r = ins(r, F_SENT0 + 3 * i, 3, src == (uint32_t)i ? sent_src - 1u : f.sent[i]);
        L.rec = r;
        mk_logreq(dst, src, fields(r), L.s0[0], L.s1[0]);
      }
      const bool stale = !lead_path && a > f.term;
      if (stale) L.rec = stepped_down(node, a);
      tag_valid = lead_path || stale;
      set_e = stale;
      break;
    }
    case T_BCAST: {  // models/raft.py:261-273
      const uint32_t payload = a & 3u;
      if (is_leader) {
        // Append, acked[me] = len, replicate.
        const uint32_t len = f.loglen + 1;
        Rec r = ins(node, F_LOGLEN, 3, len);
        const uint32_t entry = f.term | (payload << 3);
#pragma unroll
        for (int p = 0; p < (int)LOG_CAP; ++p)
          r = ins(r, LOG0 + 5 * p, 5, f.loglen == (uint32_t)p ? entry : f.log[p]);
#pragma unroll
        for (int i = 0; i < N; ++i)
          r = ins(r, F_ACKED0 + 3 * i, 3, dst == (uint32_t)i ? len : f.acked[i]);
        const Fields rf = fields(r);
        mk_logreq(dst, peer1(dst), rf, L.s0[0], L.s1[0]);
        mk_logreq(dst, peer2(dst), rf, L.s0[1], L.s1[1]);
        L.rec = r;
      } else if (no_leader) {
        // Buffer the payload.
        uint32_t nf = nonfp;
#pragma unroll
        for (int j = 0; j < (int)BUF_CAP; ++j)
          if (blen == (uint32_t)j)
            nf = (nf & ~(3u << (15 + 2 * j))) | (payload << (15 + 2 * j));
        L.nonfp = (nf & ~(3u << 13)) | ((blen + 1 < 3 ? blen + 1 : 3u) << 13);
      } else {
        // Forward to the known leader.
        L.s0[0] = T_BCAST | (dst << 3) | ((f.leader - 1u) << 5) | (payload << 7);
      }
      tag_valid = true;
      break;
    }
    default:
      break;
  }
  L.valid = occupied && first && !dst_crashed && tag_valid;
  L.tbits = set_e ? tbits | (1u << (2 * dst)) : tbits;
}

__device__ __forceinline__ void node_lane(const uint32_t* __restrict__ row, int j,
                          int max_crashes, const uint64_t (&fresh)[N], Lane& L) {
  const uint32_t i = j / 4;
  const int kind = j % 4;
  const uint32_t tbits = row[2 * N];
  const Rec node{row[2 * i], row[2 * i + 1]};
  const Fields f = fields(node);
  L.node = i;
  L.rec = node;
  L.nonfp = row[NONFP0 + i];
  L.remove = -1;
#pragma unroll
  for (int s = 0; s < SENDS; ++s) L.s0[s] = L.s1[s] = 0;
  L.flag = false;
  L.net_flag = kind < 2;
  const uint32_t my_crashed = (tbits >> (2 * N + i)) & 1u;
  if (kind == 0) {
    // Election timeout: a fired timer is always consumed; a leader ignores
    // it (models/raft.py:279-280).
    L.valid = (tbits >> (2 * i)) & 1u;
    const bool campaign = f.role != LEADER;
    const uint32_t term2 = f.term + 1;
    L.flag = L.valid && campaign && term2 > TERM_CAP;
    if (campaign) {
      Rec r = ins(node, F_TERM, 3, term2);
      r = ins(r, F_VOTED, 2, i + 1);
      r = ins(r, F_ROLE, 2, CANDIDATE);
#pragma unroll
      for (int v = 0; v < N; ++v) r = ins(r, F_VOTES + v, 1, i == (uint32_t)v ? 1u : 0u);
      L.rec = r;
      const uint32_t req = T_VOTE_REQ | (i << 3) | (term2 << 7) |
                           (f.loglen << 10) | (last_term(f) << 13);
      L.s0[0] = req | (peer1(i) << 5);
      L.s0[1] = req | (peer2(i) << 5);
    }
    L.tbits = tbits & ~(1u << (2 * i));
  } else if (kind == 1) {
    // Replication timeout: consumed even when not leader.
    L.valid = (tbits >> (2 * i + 1)) & 1u;
    if (f.role == LEADER) {
      mk_logreq(i, peer1(i), f, L.s0[0], L.s1[0]);
      mk_logreq(i, peer2(i), f, L.s0[1], L.s1[1]);
    }
    L.tbits = tbits & ~(1u << (2 * i + 1));
  } else if (kind == 2) {
    // Crash: the budget counts nodes down at the same time.
    uint32_t n_crashed = 0;
#pragma unroll
    for (int q = 0; q < N; ++q) n_crashed += (tbits >> (2 * N + q)) & 1u;
    L.valid = max_crashes != 0 && my_crashed == 0 && n_crashed < (uint32_t)max_crashes;
    L.tbits = (tbits & ~(3u << (2 * i))) | (1u << (2 * N + i));
  } else {
    // Recover: on_start's fresh record, both timers, Broadcast(own id) to
    // self (models/raft.py:133-138).
    L.valid = my_crashed == 1;
    uint64_t fr = fresh[0];
#pragma unroll
    for (int q = 1; q < N; ++q) fr = i == (uint32_t)q ? fresh[q] : fr;
    L.rec = Rec{(uint32_t)fr, (uint32_t)(fr >> 32)};
    L.nonfp = 0;
    L.tbits = (tbits & ~(1u << (2 * N + i))) | (3u << (2 * i));
    L.s0[0] = T_BCAST | (i << 3) | (i << 5) | (i << 7);
  }
}

__device__ __forceinline__ uint64_t key_of(uint32_t w0, uint32_t w1) {
  return (static_cast<uint64_t>(w0) << 32) | w1;
}

// Writes the lane's successor row; returns whether its merge overflowed.
__device__ __forceinline__ bool assemble(const uint32_t* __restrict__ row, const Lane& L,
                         uint32_t* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool mine = L.node == (uint32_t)i;
    out[2 * i] = mine ? L.rec.lo : row[2 * i];
    out[2 * i + 1] = mine ? L.rec.hi : row[2 * i + 1];
    out[NONFP0 + i] = mine ? L.nonfp : row[NONFP0 + i];
  }
  out[2 * N] = L.tbits;
  // The sends, as keys; an empty send (w0 = 0) takes no place.
  uint64_t sk[SENDS];
  int n_sends = 0;
#pragma unroll
  for (int s = 0; s < SENDS; ++s) {
    sk[s] = key_of(L.s0[s], L.s1[s]);
    n_sends += L.s0[s] != 0;
  }
  // The kept slots: the nonzero prefix without the delivered one.
  int n_slots = 0;
  for (int q = 0; q < NET_SLOTS; ++q) n_slots += row[NET0 + 2 * q] != 0;
  const bool removed = L.remove >= 0 && L.remove < n_slots;
  const int kept = n_slots - (removed ? 1 : 0);
  const int total = kept + n_sends;
  // A kept slot's place: the kept slots before it plus the sends below it
  // (on a tie the slot goes first, as in the stable sort of slots, sends).
  for (int q = 0; q < n_slots; ++q) {
    if (removed && q == L.remove) continue;
    const uint32_t w0 = row[NET0 + 2 * q], w1 = row[NET0 + 2 * q + 1];
    const uint64_t key = key_of(w0, w1);
    int pos = q - (removed && L.remove < q ? 1 : 0);
#pragma unroll
    for (int s = 0; s < SENDS; ++s) pos += L.s0[s] != 0 && sk[s] < key;
    if (pos < NET_SLOTS) {
      out[NET0 + 2 * pos] = w0;
      out[NET0 + 2 * pos + 1] = w1;
    }
  }
  // A send's place: the kept slots at or below it plus the sends below it
  // or equal and earlier.
#pragma unroll
  for (int s = 0; s < SENDS; ++s) {
    if (L.s0[s] == 0) continue;
    int pos = 0;
    for (int q = 0; q < n_slots; ++q) {
      if (removed && q == L.remove) continue;
      pos += key_of(row[NET0 + 2 * q], row[NET0 + 2 * q + 1]) <= sk[s];
    }
#pragma unroll
    for (int t = 0; t < SENDS; ++t)
      pos += L.s0[t] != 0 && (sk[t] < sk[s] || (sk[t] == sk[s] && t < s));
    if (pos < NET_SLOTS) {
      out[NET0 + 2 * pos] = L.s0[s];
      out[NET0 + 2 * pos + 1] = L.s1[s];
    }
  }
  for (int p = total; p < NET_SLOTS; ++p) {
    out[NET0 + 2 * p] = 0;
    out[NET0 + 2 * p + 1] = 0;
  }
  return total > NET_SLOTS;
}

__device__ __forceinline__ void conds_of(const uint32_t* __restrict__ row, uint8_t* __restrict__ out) {
  Fields fs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) fs[i] = fields(Rec{row[2 * i], row[2 * i + 1]});
  bool any_leader = false, any_commit = false, election_safe = true, sm_safe = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    any_leader |= fs[i].role == LEADER;
    any_commit |= fs[i].commit > 0;
#pragma unroll
    for (int j = i + 1; j < N; ++j)
      election_safe &= !(fs[i].role == LEADER && fs[j].role == LEADER &&
                         fs[i].term == fs[j].term);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      const uint32_t ni = row[NONFP0 + i], nj = row[NONFP0 + j];
#pragma unroll
      for (int p = 0; p < (int)DELIV_CAP; ++p) {
        const bool in_both = (uint32_t)p < (ni & 7u) && (uint32_t)p < (nj & 7u);
        sm_safe &= !(in_both && ((ni >> (3 + 2 * p)) & 3u) != ((nj >> (3 + 2 * p)) & 3u));
      }
    }
  }
  out[0] = any_leader;
  out[1] = any_commit;
  out[2] = election_safe;
  out[3] = sm_safe;
}

__global__ void raft_step_kernel(const uint32_t* __restrict__ states, int64_t f,
                                 int max_crashes, uint64_t fresh0,
                                 uint64_t fresh1, uint64_t fresh2,
                                 uint32_t* __restrict__ nexts,
                                 uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ conds,
                                 uint8_t* __restrict__ flags) {
  const uint64_t fresh[N] = {fresh0, fresh1, fresh2};
  const int64_t total = f * A;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t st = t / A;
    const int lane = static_cast<int>(t - st * A);
    const uint32_t* row = states + st * W;
    Lane L;
    if (lane < NET_SLOTS) {
      deliver_lane(row, lane, L);
    } else {
      node_lane(row, lane - NET_SLOTS, max_crashes, fresh, L);
    }
    const bool overflow = assemble(row, L, nexts + t * W);
    valid[t] = L.valid;
    if (L.valid && (L.flag || (L.net_flag && overflow))) flags[st] = 1;
    if (lane == 0) conds_of(row, conds + st * 4);
  }
}

}  // namespace

// states: f rows of W = 58 words whose slots are in the codec's order;
// fresh0..2: each node's on_start record (lo | hi << 32); nexts: f * 36 rows;
// valid: f * 36 bytes; conds: f * 4 bytes; flags: f bytes, zeroed by the
// caller, a state's set to 1 if one of its valid lanes overflowed the
// packed encoding.
extern "C" int sr_raft_step(const uint32_t* states, int64_t f, int max_crashes,
                            uint64_t fresh0, uint64_t fresh1, uint64_t fresh2,
                            uint32_t* nexts, uint8_t* valid, uint8_t* conds,
                            uint8_t* flags, cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 128;
  raft_step_kernel<<<sr::grid_for(f * A, kThreads), kThreads, 0, stream>>>(
      states, f, max_crashes, fresh0, fresh1, fresh2, nexts, valid, conds, flags);
  return static_cast<int>(cudaGetLastError());
}
