// K10: the ABD quorum register's successor step and property conditions,
// fused, on both fabrics.
//
// Replaces stateright_tpu/models/abd_compiled.py:465 step with its lanes
// :475 _deliver_lane (unordered) and :502 _deliver_lane_ordered (FIFO),
// :577 _assemble and :594 _handle, and :847 property_conds, with
// register_compiled_common.py:38 representative_slot_code inlined and :273
// device_linearizable through register_lin.cuh.  Row layout (C <= 3
// clients, S = 2 servers; W = 3 + M + C words):
//   words 0..1   one 29-bit server record each: seq code (4 bits, clock*S
//                + id) | value (2) | phase kind (2) | request code (3) |
//                per server a Phase1 response: presence (1), seq (4),
//                value (2) | Phase2 read value (2) | acks (2);
//   word 2       client nibbles: awaiting kind (2 bits) + op count (2);
//   words 3..    the network, M words: unordered, 6 sorted nonzero
//                envelope codes then 0; ordered, 4C + 6 words, a FIFO lane
//                per directed pair (pair_* below), messages at their queue
//                positions;
//   last C       tester words (the DP reads them at 3 + M).
// Envelope code = 1 + (tag << 18 | addr << 14 | payload).
//
// Lane k of a state delivers slot k (unordered; only the first slot of a
// run of equal codes is a lane) or the head of FIFO pair k (ordered).  The
// handler is the replica's (Put/Get start phase 1 and broadcast a Query;
// Query is answered; AckQuery completes the quorum, writes back the
// max-seq response and broadcasts a Record; Record adopts a newer seq and
// is acknowledged; AckRecord completes phase 2 and replies to the client)
// or the register client's (PutOk sends the Get; GetOk records the value).
// With skip_ack a replica answers Put and Get at once from its own state.
// Every lane's words are the JAX lane's, valid or not, u32 wrap-around
// included.  Unordered: the delivered slot leaves, the one send joins the
// slots in unsigned order.  Ordered: a delivery whose guard fails still
// consumes the head and is a valid lane with the original records; the
// pair shifts, and the send is appended at its target pair's tail, counted
// over the already shifted words.  A state's overflow byte is set when
// one of its lanes' sends does not fit (or has no lane) or its clock
// passes MAX_CLOCK.  The conds: linearizable (the DP) and value chosen (a GetOk
// with a non-null value in any network word).
//
// Bound: bytes (a row in, A successor rows and A + 2 bytes out; a few
// hundred integer operations a lane, and the C <= 3 DP is 4 x 2 words).
// Design: a thread runs one state: it loads the row into registers once
// and builds its A lanes from there, writing each output word as it is
// chosen -- the slot merge and the queue shift select by static index, so
// nothing leaves registers -- then runs the DP.  The successor rows are
// written a thread a row, so warp stores do not coalesce; a simple kernel
// first.
#include "register_client.cuh"
#include "register_lin.cuh"
#include "sr_common.cuh"

namespace {

constexpr uint32_t T_PUT = 0, T_GET = 1, T_PUTOK = 2, T_GETOK = 3;
constexpr uint32_t T_QUERY = 4, T_ACKQUERY = 5, T_RECORD = 6, T_ACKRECORD = 7;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr uint32_t S = 2;
constexpr uint32_t MAX_CLOCK = 7;
constexpr int NET0 = 3;
// Server-record field offsets.
constexpr int F_SEQ = 0, F_VAL = 4, F_KIND = 6, F_RID = 8, RESP0 = 11;
constexpr int F_READ = 25, ACKS0 = 27;

template <int C, bool ORD>
struct Geom {
  static constexpr int NPAIRS = 4 * C + 2;
  static constexpr int M = ORD ? 4 * C + 6 : 6;
  static constexpr int A = ORD ? NPAIRS : 6;
  static constexpr int TST0 = NET0 + M;
  static constexpr int W = TST0 + C;
};

// FIFO pair idx at C clients (models/abd_compiled.py fifo_pairs): client
// ci's put channel (2ci) and get channel (2ci + 1), server s's reply
// channel to client ci (2C + sC + ci), server s's peer channel (4C + s,
// three deep).
template <int C>
__host__ __device__ constexpr uint32_t pair_src(int idx) {
  return idx < 2 * C ? S + idx / 2 : idx < 4 * C ? (idx - 2 * C) / C : idx - 4 * C;
}
template <int C>
__host__ __device__ constexpr uint32_t pair_dst(int idx) {
  return idx < 2 * C   ? (idx % 2 == 0 ? (idx / 2) % S : (S + idx / 2 + 1) % S)
         : idx < 4 * C ? S + (idx - 2 * C) % C
                       : (idx - 4 * C + 1) % S;
}
template <int C>
__host__ __device__ constexpr int pair_depth(int idx) {
  return idx < 4 * C ? 1 : 3;
}
template <int C>
__host__ __device__ constexpr int pair_off(int idx) {
  return idx < 4 * C ? idx : 4 * C + 3 * (idx - 4 * C);
}

__device__ __forceinline__ uint32_t ext(uint32_t bits, int off, int width) {
  return (bits >> off) & ((1u << width) - 1u);
}

// A field insert as JAX writes it: the value is shifted, not masked to its
// width, so a wide one spills into the fields above.
__device__ __forceinline__ uint32_t ins(uint32_t bits, int off, int width,
                                        uint32_t val) {
  return (bits & ~(((1u << width) - 1u) << off)) | (val << off);
}

__device__ __forceinline__ uint32_t mk(uint32_t tag, uint32_t addr,
                                       uint32_t payload) {
  return 1u + ((tag << 18) | (addr << 14) | payload);
}

__device__ __forceinline__ uint32_t sentinel(uint32_t code) {
  return code == 0u ? ONES : code;
}

// What the handler makes of one envelope code.
struct Handled {
  bool valid;     // occupied and the handler's guard holds
  bool flag;      // the branch's clock passed MAX_CLOCK (unmasked)
  uint32_t dsrv;  // the server it is delivered to (or the client index)
  uint32_t srv;   // that server's new record
  uint32_t cli;   // the new client word
  uint32_t ci;    // the (clamped) client it is delivered to
  uint32_t tw0;   // client ci's tester word before
  uint32_t tw;    // and after
  uint32_t s0;    // the one send, 0 on an invalid lane
};

template <int C, bool ORD, bool SKIP>
__device__ __forceinline__ Handled handle(const uint32_t (&w)[Geom<C, ORD>::W],
                                          uint32_t code, bool occupied) {
  using G = Geom<C, ORD>;
  const uint32_t e = code - 1u;  // wraps to all-ones on an empty slot
  const uint32_t tag = e >> 18;
  const uint32_t addr = (e >> 14) & 0xFu;
  const uint32_t payload = e & 0x3FFFu;
  const uint32_t i_src = addr >> 2, i_dst = addr & 3u;
  Handled h;
  // A client's put goes to ci % 2, its get to (ci + 1) % 2, an internal
  // message to its address.
  h.dsrv = tag == T_PUT ? addr % S : tag == T_GET ? (addr + 1u) % S : i_dst;
  const uint32_t rec = h.dsrv == 0u ? w[0] : w[1];
  const uint32_t seq = ext(rec, F_SEQ, 4), val = ext(rec, F_VAL, 2);
  const uint32_t kind = ext(rec, F_KIND, 2), rid = ext(rec, F_RID, 3);
  const uint32_t me = h.dsrv, peer = (h.dsrv + 1u) % S;
  const uint32_t cli = w[S];
  h.ci = i_dst < C - 1 ? i_dst : C - 1;
  const uint32_t ckind = (cli >> (4u * h.ci)) & 3u;
  uint32_t tw = 0u;
#pragma unroll
  for (int i = 0; i < C; ++i) tw = h.ci == static_cast<uint32_t>(i) ? w[G::TST0 + i] : tw;
  h.tw0 = tw;
  h.srv = rec;
  h.cli = cli;
  h.tw = tw;
  h.s0 = 0u;
  h.flag = false;
  bool guard = false;
  switch (tag) {
    case T_PUT:
    case T_GET: {
      const bool is_get = tag == T_GET;
      if constexpr (SKIP) {
        // The broken replica answers at once, whatever its phase.
        guard = true;
        if (is_get) {
          h.s0 = mk(T_GETOK, me * 4u + addr, val);
        } else {
          const uint32_t clock = seq / S + 1u;
          h.srv = ins(ins(rec, F_SEQ, 4, clock * S + me), F_VAL, 2, addr + 1u);
          h.s0 = mk(T_PUTOK, me * 4u + addr, 0u);
          h.flag = clock > MAX_CLOCK;
        }
      } else {
        // An idle server enters phase 1 with its own response and
        // broadcasts a Query.
        guard = kind == 0u;
        const uint32_t pg_rid = addr | (is_get ? 4u : 0u);
        uint32_t r = ins(rec, F_KIND, 2, 1u);
        r = ins(r, F_RID, 3, pg_rid);
#pragma unroll
        for (uint32_t s = 0; s < S; ++s) {
          const bool mine = me == s;
          r = ins(r, RESP0 + 7 * s, 1, mine ? 1u : 0u);
          r = ins(r, RESP0 + 7 * s + 1, 4, mine ? seq : 0u);
          r = ins(r, RESP0 + 7 * s + 5, 2, mine ? val : 0u);
        }
        r = ins(r, F_READ, 2, 0u);
#pragma unroll
        for (uint32_t s = 0; s < S; ++s) r = ins(r, ACKS0 + s, 1, 0u);
        h.srv = r;
        h.s0 = mk(T_QUERY, me * 4u + peer, pg_rid);
      }
      break;
    }
    case T_QUERY:  // answered with (seq, val); the record unchanged
      guard = true;
      h.s0 = mk(T_ACKQUERY, i_dst * 4u + i_src, payload | (seq << 3) | (val << 7));
      break;
    case T_ACKQUERY: {
      const uint32_t aq_seq = (payload >> 3) & 0xFu, aq_val = (payload >> 7) & 3u;
      guard = kind == 1u && (payload & 7u) == rid;
      uint32_t n_resp[S], n_rseq[S], n_rval[S];
#pragma unroll
      for (uint32_t s = 0; s < S; ++s) {
        const bool from = i_src == s;
        n_resp[s] = from ? 1u : ext(rec, RESP0 + 7 * s, 1);
        n_rseq[s] = from ? aq_seq : ext(rec, RESP0 + 7 * s + 1, 4);
        n_rval[s] = from ? aq_val : ext(rec, RESP0 + 7 * s + 5, 2);
      }
      if (n_resp[0] + n_resp[1] == 2u) {
        // The quorum: the max-seq response (a write's with the next clock)
        // is written back and broadcast as a Record; phase 2 with own ack.
        const bool best1 = n_resp[1] == 1u && (n_resp[0] == 0u || n_rseq[1] > n_rseq[0]);
        const uint32_t max_seq = best1 ? n_rseq[1] : n_rseq[0];
        const uint32_t max_val = best1 ? n_rval[1] : n_rval[0];
        const bool is_write = (rid & 4u) == 0u;
        const uint32_t wclock = max_seq / S + 1u;
        const uint32_t rec_seq = is_write ? wclock * S + me : max_seq;
        const uint32_t rec_val = is_write ? rid + 1u : max_val;
        const bool adopt = rec_seq > seq;
        uint32_t r = ins(rec, F_SEQ, 4, adopt ? rec_seq : seq);
        r = ins(r, F_VAL, 2, adopt ? rec_val : val);
        r = ins(r, F_KIND, 2, 2u);
        r = ins(r, F_READ, 2, is_write ? 0u : max_val);
#pragma unroll
        for (uint32_t s = 0; s < S; ++s) {
          r = ins(r, ACKS0 + s, 1, me == s ? 1u : 0u);
          r = ins(r, RESP0 + 7 * s, 1, 0u);
          r = ins(r, RESP0 + 7 * s + 1, 4, 0u);
          r = ins(r, RESP0 + 7 * s + 5, 2, 0u);
        }
        h.srv = r;
        h.s0 = mk(T_RECORD, me * 4u + peer, rid | (rec_seq << 3) | (rec_val << 7));
        h.flag = guard && is_write && wclock > MAX_CLOCK;
      } else {
        uint32_t r = rec;
#pragma unroll
        for (uint32_t s = 0; s < S; ++s) {
          r = ins(r, RESP0 + 7 * s, 1, n_resp[s]);
          r = ins(r, RESP0 + 7 * s + 1, 4, n_rseq[s]);
          r = ins(r, RESP0 + 7 * s + 5, 2, n_rval[s]);
        }
        h.srv = r;
      }
      break;
    }
    case T_RECORD: {  // adopt a newer (seq, val); acknowledge
      guard = true;
      const uint32_t r_seq = (payload >> 3) & 0xFu, r_val = (payload >> 7) & 3u;
      const bool adopt = r_seq > seq;
      h.srv = ins(ins(rec, F_SEQ, 4, adopt ? r_seq : seq), F_VAL, 2, adopt ? r_val : val);
      h.s0 = mk(T_ACKRECORD, i_dst * 4u + i_src, payload & 7u);
      break;
    }
    case T_ACKRECORD: {
      const uint32_t ack0 = ext(rec, ACKS0, 1), ack1 = ext(rec, ACKS0 + 1, 1);
      guard = kind == 2u && (payload & 7u) == rid && (i_src == 0u ? ack0 : ack1) == 0u;
      const uint32_t n0 = i_src == 0u ? 1u : ack0, n1 = i_src == 1u ? 1u : ack1;
      if (n0 + n1 == 2u) {
        // The quorum: reply to the requester, clear the phase.
        uint32_t r = ins(rec, F_KIND, 2, 0u);
        r = ins(r, F_RID, 3, 0u);
        r = ins(r, F_READ, 2, 0u);
        r = ins(ins(r, ACKS0, 1, 0u), ACKS0 + 1, 1, 0u);
        h.srv = r;
        const uint32_t to = me * 4u + (rid & 3u);
        h.s0 = (rid & 4u) ? mk(T_GETOK, to, ext(rec, F_READ, 2)) : mk(T_PUTOK, to, 0u);
      } else {
        h.srv = ins(ins(rec, ACKS0, 1, n0), ACKS0 + 1, 1, n1);
      }
      break;
    }
    case T_PUTOK:
      guard = ckind == 1u && i_dst < C;
      regcli::putok<C, G::TST0>(w, cli, tw, h.ci, h.cli, h.tw);
      h.s0 = mk(T_GET, h.ci, 0u);
      break;
    case T_GETOK:
      guard = ckind == 2u && i_dst < C;
      regcli::getok<C>(cli, tw, h.ci, payload, h.cli, h.tw);
      break;
    default:
      break;
  }
  h.valid = occupied && guard;
  if (!h.valid) h.s0 = 0u;  // no phantom send from an invalid lane
  return h;
}

// The records and tester words of a lane's successor.
template <int C, bool ORD>
__device__ __forceinline__ void assemble(const uint32_t (&w)[Geom<C, ORD>::W],
                                         uint32_t dsrv, uint32_t srv,
                                         uint32_t cli, uint32_t ci, uint32_t tw,
                                         uint32_t* __restrict__ out) {
  using G = Geom<C, ORD>;
  out[0] = dsrv == 0u ? srv : w[0];
  out[1] = dsrv == 1u ? srv : w[1];
  out[2] = cli;
#pragma unroll
  for (int i = 0; i < C; ++i)
    out[G::TST0 + i] = ci == static_cast<uint32_t>(i) ? tw : w[G::TST0 + i];
}

// Unordered lane k: writes its successor to out[]; returns its flag.
template <int C, bool SKIP>
__device__ __forceinline__ bool unordered_lane(const uint32_t (&w)[Geom<C, false>::W],
                                               int k, uint32_t* __restrict__ out,
                                               bool& valid) {
  using G = Geom<C, false>;
  // The slot before k = 0 reads as 0; static indices only.
  uint32_t code = 0u, prev = 0u;
#pragma unroll
  for (int q = 0; q < G::M; ++q) {
    code = q == k ? w[NET0 + q] : code;
    prev = q + 1 == k ? w[NET0 + q] : prev;
  }
  const bool occupied = code != 0u && (k == 0 || prev != code);
  const Handled h = handle<C, false, SKIP>(w, code, occupied);
  valid = h.valid;
  // Merge the remaining slots (slot k removed) with the send; empty slots
  // are 0xFFFFFFFF so they sort last, unsigned.
  const uint32_t a = sentinel(h.s0);
  int ri = 0;         // next remaining slot, counting past slot k
  bool used = false;  // the send placed
#pragma unroll
  for (int p = 0; p < G::M; ++p) {
    const int q = ri + (ri >= k ? 1 : 0);
    uint32_t rv = ONES;
#pragma unroll
    for (int t = 0; t < G::M; ++t) rv = t == q ? sentinel(w[NET0 + t]) : rv;
    const uint32_t sv = used ? ONES : a;
    uint32_t x;
    if (rv <= sv) { x = rv; ++ri; } else { x = sv; used = true; }
    out[NET0 + p] = x == ONES ? 0u : x;
  }
  const int q = ri + (ri >= k ? 1 : 0);
  uint32_t rv = ONES;
#pragma unroll
  for (int t = 0; t < G::M; ++t) rv = t == q ? sentinel(w[NET0 + t]) : rv;
  const bool overflow = h.valid && (rv != ONES || (!used && a != ONES));
  assemble<C, false>(w, h.dsrv, h.srv, h.cli, h.ci, h.tw, out);
  return (h.flag && h.valid) || overflow;
}

// Ordered lane k, the head of FIFO pair k: writes its successor to out[];
// returns its flag.
template <int C, bool SKIP>
__device__ __forceinline__ bool ordered_lane(const uint32_t (&w)[Geom<C, true>::W],
                                             int k, uint32_t* __restrict__ out,
                                             bool& valid) {
  using G = Geom<C, true>;
  uint32_t code = 0u;
#pragma unroll
  for (int idx = 0; idx < G::NPAIRS; ++idx)
    code = idx == k ? w[NET0 + pair_off<C>(idx)] : code;
  const bool occupied = code != 0u;
  const Handled h = handle<C, true, SKIP>(w, code, occupied);
  // A delivery whose guard fails still consumes the head: the lane is
  // valid, with the original records and no send.
  valid = occupied;
  const uint32_t srv = h.valid ? h.srv : (h.dsrv == 0u ? w[0] : w[1]);
  const uint32_t cli = h.valid ? h.cli : w[S];
  const uint32_t tw = h.valid ? h.tw : h.tw0;

  // The send's pair, from its tag and address.
  const uint32_t es = h.s0 - 1u;
  const uint32_t t_tag = es >> 18, t_addr = (es >> 14) & 0xFu;
  const bool is_reply = t_tag == T_PUTOK || t_tag == T_GETOK;
  const bool is_get = t_tag == T_GET;
  const uint32_t t_src = is_get ? S + t_addr : t_addr >> 2;
  const uint32_t t_dst = is_reply ? S + (t_addr & 3u)
                         : is_get ? (t_addr + S + 1u) % S
                                  : t_addr & 3u;
  const bool has_send = h.s0 != 0u;
  int t_pair = G::NPAIRS;  // no lane
#pragma unroll
  for (int idx = 0; idx < G::NPAIRS; ++idx)
    if (t_src == pair_src<C>(idx) && t_dst == pair_dst<C>(idx)) t_pair = idx;

  bool overflow = false;
#pragma unroll
  for (int idx = 0; idx < G::NPAIRS; ++idx) {
    constexpr int MAXD = 3;
    const int depth = pair_depth<C>(idx), off = pair_off<C>(idx);
    uint32_t q[MAXD];
    int ln = 0;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j >= depth) break;
      const uint32_t nxt = j + 1 < depth ? w[NET0 + off + j + 1] : 0u;
      q[j] = idx == k ? nxt : w[NET0 + off + j];
      ln += q[j] != 0u ? 1 : 0;
    }
    const bool target = has_send && t_pair == idx;
#pragma unroll
    for (int j = 0; j < MAXD; ++j) {
      if (j >= depth) break;
      out[NET0 + off + j] = target && ln == j ? h.s0 : q[j];
    }
    overflow |= target && ln == depth;
  }
  assemble<C, true>(w, h.dsrv, srv, cli, h.ci, tw, out);
  return (h.flag && h.valid) || overflow || (has_send && t_pair == G::NPAIRS);
}

template <int C, bool ORD, bool SKIP>
__global__ void abd_step_kernel(const uint32_t* __restrict__ states, int64_t f,
                                uint32_t* __restrict__ nexts,
                                uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ conds,
                                uint8_t* __restrict__ flags) {
  using G = Geom<C, ORD>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t st = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       st < f; st += stride) {
    const uint32_t* row = states + st * G::W;
    uint32_t w[G::W];
#pragma unroll
    for (int i = 0; i < G::W; ++i) w[i] = row[i];
    bool over = false;
    for (int k = 0; k < G::A; ++k) {
      uint32_t* out = nexts + (st * G::A + k) * G::W;
      bool v;
      if constexpr (ORD) {
        over |= ordered_lane<C, SKIP>(w, k, out, v);
      } else {
        over |= unordered_lane<C, SKIP>(w, k, out, v);
      }
      valid[st * G::A + k] = v ? 1 : 0;
    }
    flags[st] = over ? 1 : 0;
    bool chosen = false;
#pragma unroll
    for (int i = 0; i < G::M; ++i) {
      const uint32_t e = w[NET0 + i] - 1u;
      chosen |= w[NET0 + i] != 0u && (e >> 18) == T_GETOK && (e & 0x3FFFu) != 0u;
    }
    uint32_t tw[C];
#pragma unroll
    for (int i = 0; i < C; ++i) tw[i] = w[G::TST0 + i];
    conds[2 * st] = reglin::linearizable<C>(tw, 0) ? 1 : 0;
    conds[2 * st + 1] = chosen ? 1 : 0;
  }
}

template <int C, bool ORD, bool SKIP>
void launch(const uint32_t* states, int64_t f, uint32_t* nexts, uint8_t* valid,
            uint8_t* conds, uint8_t* flags, cudaStream_t stream) {
  constexpr int kThreads = 128;
  abd_step_kernel<C, ORD, SKIP><<<sr::grid_for(f, kThreads), kThreads, 0, stream>>>(
      states, f, nexts, valid, conds, flags);
}

template <int C>
void launch_c(const uint32_t* states, int64_t f, int ordered, int skip_ack,
              uint32_t* nexts, uint8_t* valid, uint8_t* conds, uint8_t* flags,
              cudaStream_t stream) {
  if (ordered) {
    if (skip_ack) launch<C, true, true>(states, f, nexts, valid, conds, flags, stream);
    else launch<C, true, false>(states, f, nexts, valid, conds, flags, stream);
  } else {
    if (skip_ack) launch<C, false, true>(states, f, nexts, valid, conds, flags, stream);
    else launch<C, false, false>(states, f, nexts, valid, conds, flags, stream);
  }
}

}  // namespace

// states: f rows of W words; nexts: f * A rows; valid: f * A bytes; conds:
// f * 2 bytes; flags: f bytes, each state's 1 if one of its lanes
// overflowed the packed encoding, else 0.
extern "C" int sr_abd_step(const uint32_t* states, int64_t f, int c,
                           int ordered, int skip_ack, uint32_t* nexts,
                           uint8_t* valid, uint8_t* conds, uint8_t* flags,
                           cudaStream_t stream) {
  if (f <= 0) return 0;
  switch (c) {
    case 1: launch_c<1>(states, f, ordered, skip_ack, nexts, valid, conds, flags, stream); break;
    case 2: launch_c<2>(states, f, ordered, skip_ack, nexts, valid, conds, flags, stream); break;
    case 3: launch_c<3>(states, f, ordered, skip_ack, nexts, valid, conds, flags, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
