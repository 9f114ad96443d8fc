// K9: the single-copy register's successor step and property conditions,
// fused.
//
// Replaces stateright_tpu/models/single_copy_compiled.py:202 step / :210
// _deliver_lane and :309 property_conds, with register_compiled_common.py
// :38 representative_slot_code inlined and :273 device_linearizable through
// register_lin.cuh.  Row layout (C clients, S <= 2 servers, M = 4 slots for
// C <= 2 and 8 above, W = 2 + M + C words):
//   word 0       the server values, VB = max(2, bit_length(C)) bits each;
//   word 1       client nibbles: awaiting kind (2 bits) + op count (2);
//   words 2..    M network slots: sorted nonzero envelope codes, then 0;
//   last C       tester words.
// Envelope code = 1 + (tag << 19 | addr << 14 | payload).  Lane k of a
// state delivers slot k: a Put stores the client's value and answers PutOk,
// a Get answers GetOk with the value, a PutOk or GetOk moves the client and
// its tester record on (the register harness).  Every lane's words are the
// JAX step's, valid or not; the delivered envelope leaves the slots, the
// one send joins them in unsigned order, and a send that does not fit
// raises the state's overflow flag (one byte a state).
// The conds: linearizable (the DP) and value chosen (a GetOk with a
// non-null value in flight).
//
// Bound: bytes up to C = 3 (a row in, M successor rows and M + 2 bytes
// out, a few hundred operations a lane); operations at C = 4, where the DP
// (5 x 8 words, at most 8 x 8 op sweeps) outweighs the lanes.
// Design: a group of reglin::Dims<C>::L threads per state -- one thread up
// to C = 4, a warp from C = 5 -- loads the row into registers once; its
// threads build the state's lanes in turn (the slot merge writes each
// output slot as it is chosen, from the row in registers) and then run the
// DP together; thread 0 of the group writes the conds.
#include "register_client.cuh"
#include "register_lin.cuh"
#include "sr_common.cuh"

namespace {

constexpr uint32_t T_PUT = 0, T_GET = 1, T_PUTOK = 2, T_GETOK = 3;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr int NET0 = 2;

template <int C>
struct Geom {
  static constexpr int M = C <= 2 ? 4 : 8;
  static constexpr int TST0 = NET0 + M;
  static constexpr int W = TST0 + C;
  static constexpr int VB = reglin::Dims<C>::VB;
};

__device__ __forceinline__ uint32_t mk(uint32_t tag, uint32_t addr,
                                       uint32_t payload) {
  return 1u + ((tag << 19) | (addr << 14) | payload);
}

__device__ __forceinline__ uint32_t sentinel(uint32_t code) {
  return code == 0u ? ONES : code;
}

// Lane k of a state whose row is in w[]: writes its successor to out[] and
// returns (valid, overflowed) through its arguments.
template <int C>
__device__ __forceinline__ void deliver_lane(const uint32_t (&w)[Geom<C>::W],
                                             int k, uint32_t s,
                                             uint32_t* __restrict__ out,
                                             bool& valid, bool& overflow) {
  using G = Geom<C>;
  const uint32_t srv = w[0], cli = w[1];
  // The slot before k = 0 reads as 0; static indices only.
  uint32_t code = 0u, prev = 0u;
#pragma unroll
  for (int q = 0; q < G::M; ++q) {
    code = q == k ? w[NET0 + q] : code;
    prev = q + 1 == k ? w[NET0 + q] : prev;
  }
  const bool occupied = code != 0u && (k == 0 || prev != code);
  const uint32_t e = code - 1u;  // wraps to all-ones on an empty slot
  const uint32_t tag = e >> 19;
  const uint32_t addr = (e >> 14) & 0x1Fu;
  const uint32_t payload = e & 0x3FFFu;
  const uint32_t i_dst = addr & 7u;

  // Put goes to (s+ci) % s, Get to (s+ci+1) % s (actor/register.py).
  const uint32_t dsrv = tag == T_PUT ? (addr + s) % s : (addr + s + 1u) % s;
  const uint32_t vmask = (1u << G::VB) - 1u;
  const uint32_t sh = G::VB * dsrv;
  const uint32_t sval = (srv >> sh) & vmask;

  const uint32_t ci = i_dst < C - 1 ? i_dst : C - 1;  // clamped client
  const uint32_t kind = (cli >> (4u * ci)) & 3u;
  uint32_t tw = 0u;
#pragma unroll
  for (int i = 0; i < C; ++i) tw = ci == static_cast<uint32_t>(i) ? w[G::TST0 + i] : tw;

  uint32_t nsrv = srv, ncli = cli, ntw = tw, s0 = 0u;
  bool guard = false;
  switch (tag) {
    case T_PUT:  // store the value, reply PutOk
      guard = true;
      nsrv = (srv & ~(vmask << sh)) | ((addr + 1u) << sh);
      s0 = mk(T_PUTOK, dsrv * 8u + addr, 0u);
      break;
    case T_GET:  // reply with the value held
      guard = true;
      s0 = mk(T_GETOK, dsrv * 8u + addr, sval);
      break;
    case T_PUTOK:  // client ci: (put, 1) -> (get, 2); tester 1 -> 3
      guard = kind == 1u && i_dst < C;
      regcli::putok<C, G::TST0>(w, cli, tw, ci, ncli, ntw);
      s0 = mk(T_GET, ci, 0u);
      break;
    case T_GETOK:  // client ci: (get, 2) -> (done, 3); tester 3 -> 4
      guard = kind == 2u && i_dst < C;
      regcli::getok<C>(cli, tw, ci, payload, ncli, ntw);
      break;
    default:
      break;
  }
  valid = occupied && guard;
  if (!valid) s0 = 0u;  // no phantom send from an invalid lane

  // Slots: merge the remaining slots (slot k removed) with the send; empty
  // slots are 0xFFFFFFFF so they sort last, unsigned.
  const uint32_t a = sentinel(s0);
  int ri = 0;          // next remaining slot, counting past slot k
  bool used = false;   // the send placed
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
  overflow = valid && (rv != ONES || (!used && a != ONES));
  out[0] = tag == T_PUT ? nsrv : srv;
  out[1] = ncli;
#pragma unroll
  for (int i = 0; i < C; ++i)
    out[G::TST0 + i] = ci == static_cast<uint32_t>(i) ? ntw : w[G::TST0 + i];
}

template <int C>
__global__ void single_copy_step_kernel(const uint32_t* __restrict__ states,
                                        int64_t f, int s,
                                        uint32_t* __restrict__ nexts,
                                        uint8_t* __restrict__ valid,
                                        uint8_t* __restrict__ conds,
                                        uint8_t* __restrict__ flags) {
  using G = Geom<C>;
  constexpr int L = reglin::Dims<C>::L;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int r = static_cast<int>(tid % L);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / L;
  // Every thread of a group runs the same trip count (blockDim.x is a
  // multiple of 32), as the DP's warp collectives need.
  for (int64_t st = tid / L; st < f; st += stride) {
    const uint32_t* row = states + st * G::W;
    uint32_t w[G::W];
#pragma unroll
    for (int i = 0; i < G::W; ++i) w[i] = row[i];
    bool over = false, chosen = false;
    for (int k = r; k < G::M; k += L) {
      bool v, o;
      deliver_lane<C>(w, k, static_cast<uint32_t>(s),
                      nexts + (st * G::M + k) * G::W, v, o);
      valid[st * G::M + k] = v ? 1 : 0;
      over |= o;
      const uint32_t code = row[NET0 + k];
      const uint32_t e = code - 1u;
      chosen |= code != 0u && (e >> 19) == T_GETOK && (e & 0x3FFFu) != 0u;
    }
    over = reglin::group_any<L>(over);
    chosen = reglin::group_any<L>(chosen);
    uint32_t tw[C];
#pragma unroll
    for (int i = 0; i < C; ++i) tw[i] = w[G::TST0 + i];
    const bool lin = reglin::linearizable<C>(tw, r);
    if (r == 0) {
      flags[st] = over ? 1 : 0;
      conds[2 * st] = lin ? 1 : 0;
      conds[2 * st + 1] = chosen ? 1 : 0;
    }
  }
}

}  // namespace

// states: f rows of Geom<c>::W words; nexts: f * M rows; valid: f * M
// bytes; conds: f * 2 bytes; flags: f bytes, each state's 1 if one of its
// lanes overflowed its slots, else 0.
extern "C" int sr_single_copy_step(const uint32_t* states, int64_t f, int s,
                                   int c, uint32_t* nexts, uint8_t* valid,
                                   uint8_t* conds, uint8_t* flags,
                                   cudaStream_t stream) {
  if (f <= 0) return 0;
  if (s < 1 || s > 2) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
#define LAUNCH(C)                                                            \
  single_copy_step_kernel<C><<<sr::grid_for(f * reglin::Dims<C>::L,          \
                                            kThreads),                       \
                               kThreads, 0, stream>>>(states, f, s, nexts,   \
                                                      valid, conds, flags)
  switch (c) {
    case 1: { LAUNCH(1); break; }
    case 2: { LAUNCH(2); break; }
    case 3: { LAUNCH(3); break; }
    case 4: { LAUNCH(4); break; }
    case 5: { LAUNCH(5); break; }
    case 6: { LAUNCH(6); break; }
    case 7: { LAUNCH(7); break; }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
