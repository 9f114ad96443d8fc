// K16: the LWW-register CRDT's step, encoding flag and property condition.
//
// Replaces stateright_tpu/models/lww_compiled.py:195 step (:254
// _deliver_lane, :301 _random_lane) and :372 property_conds.  Row: N node
// words (present 1 | value 2 | timestamp 6 | updater 2 | clock 6 | max
// used 6) then 12 sorted envelope codes, 0 = empty.  Lanes, A = 12 + 5N:
//
// - Deliver(slot k), k < 12: valid if the slot is occupied and the first
//   of its equal run; the receiver keeps its register iff (t_a, u_a) >
//   (t_b, u_b) and takes the message's otherwise (always with no
//   register); the slot is removed and the slots re-sort;
// - SelectRandom(node i, choice c), lane 12 + 5i + c, always valid:
//   SetValue(c) for c < 3 stamps cv = max(clock, max_used + 1) with a
//   register (clock without), broadcasts to every node, the sender
//   included, and flags cv > 63 or a send past the 12 slots;
//   SetTime(clock + 1) flags past 63, SetTime(clock - 1) flags at 0.
//
// Every field's arithmetic is the JAX code's in u32, unmasked where it is
// unmasked there (a cv of 64 spills into the updater bits, as in JAX), and
// invalid lanes' successors are built as JAX builds them.  A state's flag
// is any of its valid lanes' flags; the wrapper zeroes the flags, and a
// flagged lane writes 1.  Lane 0 writes the state's condition: the network
// is not empty, or every register equals node 0's.
//
// Design: one thread per (state, lane), a state's lanes adjacent.  The
// slots (and a SetValue's sends) go through an insertion network on a
// register array of 12 + N words, empty as 0xFFFFFFFF, unsigned: a fixed
// sequence of compare-exchanges with constant indices, so nothing leaves
// registers.  Bound: bytes -- each lane writes its (N + 12)-word successor
// and a valid byte, each state's row is read from memory once.
#include "sr_common.cuh"

namespace {

constexpr int kSlots = 12;
constexpr int kChoices = 5;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t node_word(uint32_t present, uint32_t val,
                                              uint32_t ts, uint32_t up,
                                              uint32_t clock, uint32_t max_used) {
  return present | (val << 1) | (ts << 3) | (up << 9) | (clock << 11) |
         (max_used << 17);
}

template <int N>
__global__ void lww_kernel(const uint32_t* __restrict__ states, int64_t f,
                           uint32_t* __restrict__ nexts,
                           uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ flags,
                           uint8_t* __restrict__ conds) {
  constexpr int W = N + kSlots;
  constexpr int A = kSlots + kChoices * N;
  constexpr int K = kSlots + N;
  const uint64_t n_lanes = static_cast<uint64_t>(f) * A;
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t t = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n_lanes; t += stride) {
    const uint64_t s = t / A;
    const int lane = static_cast<int>(t - s * A);
    const uint32_t* st = states + s * W;
    uint32_t node[N], head[N], slot[kSlots], a[K];
#pragma unroll
    for (int i = 0; i < N; ++i) head[i] = node[i] = st[i];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) slot[j] = st[N + j];

    bool ok = true, flag = false, sends = false;
    if (lane < kSlots) {  // Deliver(slot lane)
      uint32_t code = 0, prev = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (j == lane) code = slot[j];
        if (j + 1 == lane) prev = slot[j];
      }
      ok = code != 0 && (lane == 0 || prev != code);
      const uint32_t e = code - 1u;
      const uint32_t dst = (e >> 2) & 3u, mv = (e >> 4) & 3u;
      const uint32_t mt = (e >> 6) & 63u, mu = (e >> 12) & 3u;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (dst == static_cast<uint32_t>(i)) word = node[i];
      const uint32_t present = word & 1u, val = (word >> 1) & 3u;
      const uint32_t ts = (word >> 3) & 63u, up = (word >> 9) & 3u;
      const bool a_wins = present == 1u && (ts > mt || (ts == mt && up > mu));
      const uint32_t nw = node_word(1u, a_wins ? val : mv, a_wins ? ts : mt,
                                    a_wins ? up : mu, (word >> 11) & 63u,
                                    (word >> 17) & 63u);
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (dst == static_cast<uint32_t>(i)) head[i] = nw;
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        a[j] = (j == lane || slot[j] == 0) ? kEmpty : slot[j];
#pragma unroll
      for (int p = 0; p < N; ++p) a[kSlots + p] = kEmpty;
    } else {  // SelectRandom(node i, choice c)
      const int r = lane - kSlots;
      const int i = r / kChoices, c = r - i * kChoices;
      uint32_t word = 0;
#pragma unroll
      for (int ii = 0; ii < N; ++ii)
        if (ii == i) word = node[ii];
      const uint32_t present = word & 1u, val = (word >> 1) & 3u;
      const uint32_t ts = (word >> 3) & 63u, up = (word >> 9) & 3u;
      const uint32_t clock = (word >> 11) & 63u, max_used = (word >> 17) & 63u;
      uint32_t nw;
      uint32_t cv = 0;
      if (c < 3) {  // SetValue(VALUES[c])
        const uint32_t bumped = max_used + 1u;
        cv = present == 1u ? (clock > bumped ? clock : bumped) : clock;
        flag = cv > 63u;
        nw = node_word(1u, static_cast<uint32_t>(c), cv, static_cast<uint32_t>(i),
                       clock, present == 1u ? cv : max_used);
        sends = true;
      } else if (c == 3) {  // SetTime(clock + 1)
        flag = clock + 1u > 63u;
        nw = node_word(present, val, ts, up, clock + 1u, max_used);
      } else {  // SetTime(max(clock - 1, 0)): the offset floor
        flag = clock == 0u;
        nw = node_word(present, val, ts, up, clock - 1u, max_used);
      }
#pragma unroll
      for (int ii = 0; ii < N; ++ii)
        if (ii == i) head[ii] = nw;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) a[j] = slot[j] == 0 ? kEmpty : slot[j];
      const uint32_t ui = static_cast<uint32_t>(i);
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const uint32_t send =
            1u + (ui | (static_cast<uint32_t>(p) << 2) |
                  (static_cast<uint32_t>(c) << 4) | (cv << 6) | (ui << 12));
        a[kSlots + p] = sends ? send : kEmpty;
      }
    }
    // Insertion network: ascending, unsigned.
#pragma unroll
    for (int x = 1; x < K; ++x) {
#pragma unroll
      for (int y = x; y > 0; --y) {
        const uint32_t lo = a[y - 1] < a[y] ? a[y - 1] : a[y];
        const uint32_t hi = a[y - 1] < a[y] ? a[y] : a[y - 1];
        a[y - 1] = lo;
        a[y] = hi;
      }
    }
    if (sends && a[kSlots] != kEmpty) flag = true;  // a send past the slots

    uint32_t* out = nexts + t * W;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = head[i];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) out[N + j] = a[j] == kEmpty ? 0u : a[j];
    valid[t] = ok ? 1 : 0;
    if (ok && flag) flags[s] = 1;
    if (lane == 0) {
      bool net_empty = true;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) net_empty = net_empty && slot[j] == 0;
      bool agree = true;
      const uint32_t reg0 = node[0] & 0x7FFu;  // present, value, ts, updater
#pragma unroll
      for (int i = 1; i < N; ++i) {
        const bool same = (node[i] & 0x7FFu) == reg0;
        const bool none_both = (node[i] & 1u) == 0 && (node[0] & 1u) == 0;
        agree = agree && (same || none_both);
      }
      conds[s] = (!net_empty || agree) ? 1 : 0;
    }
  }
}

}  // namespace

// states: f rows of n + 12 words; nexts: f * A rows; valid: f * A bytes;
// flags: f bytes, zero on entry; conds: f bytes.  A = 12 + 5n, n = 1..3.
extern "C" int sr_lww_step(const uint32_t* states, int64_t f, int n,
                           uint32_t* nexts, uint8_t* valid, uint8_t* flags,
                           uint8_t* conds, cudaStream_t stream) {
  if (f <= 0) return 0;
  if (n < 1 || n > 3) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const int64_t lanes = f * (kSlots + kChoices * n);
  const unsigned grid = sr::grid_for(lanes, kThreads);
  if (n == 1) {
    lww_kernel<1><<<grid, kThreads, 0, stream>>>(states, f, nexts, valid, flags, conds);
  } else if (n == 2) {
    lww_kernel<2><<<grid, kThreads, 0, stream>>>(states, f, nexts, valid, flags, conds);
  } else {
    lww_kernel<3><<<grid, kThreads, 0, stream>>>(states, f, nexts, valid, flags, conds);
  }
  return static_cast<int>(cudaGetLastError());
}
