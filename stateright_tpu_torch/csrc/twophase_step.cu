// K2: the two-phase-commit successor step and property conditions, fused.
//
// Replaces stateright_tpu/models/twophase_compiled.py:95 TwoPhaseCompiled.step
// and :173 property_conds, with the same guards and bit layout:
//   word0: RM states, 2 bits at 2*i (WORKING 0, PREPARED 1, COMMITTED 2,
//          ABORTED 3); TM state (INIT 0, COMMITTED 1, ABORTED 2) at bit 24.
//   word1: tm_prepared bit i; Prepared(i) message at bit n+i; Commit at 2n;
//          Abort at 2n+1.
// Action lanes: 0 TmCommit, 1 TmAbort, then per RM rm the five lanes
// 2+5rm+{0 TmRcvPrepared, 1 RmPrepare, 2 RmChooseToAbort, 3 RmRcvCommitMsg,
// 4 RmRcvAbortMsg}.  Invalid lanes still carry the words the JAX step
// computes for them, so the outputs are bit-equal lane for lane.
//
// Bound: bytes.  Each state (8 bytes) produces A = 2+5n successor lanes of
// 8 bytes plus a validity byte: the output is ~50x the input, and the guard
// arithmetic is a handful of integer operations per lane.
// Design: one thread per (state, action) lane in a grid-stride loop, so
// neighbouring threads write neighbouring successor words and validity bytes
// (coalesced stores); the two state words are re-read by the A threads of a
// state and served from L1.  The lane of action 0 also writes the state's
// three property conditions.  n is a runtime argument (n <= 12).
//
// K2c, sr_twophase_conds: the conditions alone, with no successor rows --
// what the incremental store's property re-check (incr/recheck.py) and a
// model whose property_conds differs from K2's fused one launch.  With
// `some_prepared` set it appends the column "some rm prepared" of
// stateright_tpu/models/fixtures.py:501 TwoPhaseEdited (an OR over the RMs of
// (w0 >> 2rm) & 3 == PREPARED).  Bound: bytes -- a row of 8 bytes read (the
// conds need word0 only, but its 4-byte reads at an 8-byte stride pull whole
// sectors) and P bytes written a state.  One thread per state in a
// grid-stride loop.
#include "sr_common.cuh"

namespace {

constexpr int kTmShift = 24;

__global__ void twophase_step_kernel(const uint32_t* __restrict__ states,
                                     int64_t f, int n,
                                     uint32_t* __restrict__ nexts,
                                     uint8_t* __restrict__ valid,
                                     uint8_t* __restrict__ conds) {
  const int a_count = 2 + 5 * n;
  const int64_t lanes = f * a_count;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint32_t prepared_mask = (1u << n) - 1u;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < lanes; t += stride) {
    const int64_t s = t / a_count;
    const int a = static_cast<int>(t - s * a_count);
    const uint32_t w0 = states[2 * s];
    const uint32_t w1 = states[2 * s + 1];
    const bool tm_init = ((w0 >> kTmShift) & 3u) == 0u;
    bool v;
    uint32_t n0, n1;
    if (a < 2) {
      const uint32_t w0_tm_cleared = w0 & ~(3u << kTmShift);
      if (a == 0) {  // TmCommit
        v = tm_init && (w1 & prepared_mask) == prepared_mask;
        n0 = w0_tm_cleared | (1u << kTmShift);
        n1 = w1 | (1u << (2 * n));
      } else {  // TmAbort
        v = tm_init;
        n0 = w0_tm_cleared | (2u << kTmShift);
        n1 = w1 | (1u << (2 * n + 1));
      }
    } else {
      const int rm = (a - 2) / 5;
      const int k = (a - 2) - 5 * rm;
      const bool rm_working = ((w0 >> (2 * rm)) & 3u) == 0u;
      const uint32_t w0_rm_cleared = w0 & ~(3u << (2 * rm));
      switch (k) {
        case 0:  // TmRcvPrepared(rm)
          v = tm_init && ((w1 >> (n + rm)) & 1u);
          n0 = w0;
          n1 = w1 | (1u << rm);
          break;
        case 1:  // RmPrepare(rm)
          v = rm_working;
          n0 = w0_rm_cleared | (1u << (2 * rm));
          n1 = w1 | (1u << (n + rm));
          break;
        case 2:  // RmChooseToAbort(rm)
          v = rm_working;
          n0 = w0_rm_cleared | (3u << (2 * rm));
          n1 = w1;
          break;
        case 3:  // RmRcvCommitMsg(rm)
          v = (w1 >> (2 * n)) & 1u;
          n0 = w0_rm_cleared | (2u << (2 * rm));
          n1 = w1;
          break;
        default:  // RmRcvAbortMsg(rm)
          v = (w1 >> (2 * n + 1)) & 1u;
          n0 = w0_rm_cleared | (3u << (2 * rm));
          n1 = w1;
          break;
      }
    }
    nexts[2 * t] = n0;
    nexts[2 * t + 1] = n1;
    valid[t] = v ? 1 : 0;
    if (a == 0) {
      bool committed = false, aborted = false;
      bool all_committed = true, all_aborted = true;
      for (int rm = 0; rm < n; ++rm) {
        const uint32_t rs = (w0 >> (2 * rm)) & 3u;
        committed |= rs == 2u;
        aborted |= rs == 3u;
        all_committed &= rs == 2u;
        all_aborted &= rs == 3u;
      }
      // Order of TwoPhaseSys.properties(): abort agreement, commit
      // agreement, consistent.
      conds[3 * s] = all_aborted ? 1 : 0;
      conds[3 * s + 1] = all_committed ? 1 : 0;
      conds[3 * s + 2] = (aborted && committed) ? 0 : 1;
    }
  }
}

__global__ void twophase_conds_kernel(const uint32_t* __restrict__ states,
                                      int64_t f, int n, int some_prepared,
                                      uint8_t* __restrict__ conds) {
  const int p = 3 + (some_prepared ? 1 : 0);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < f; s += stride) {
    const uint32_t w0 = states[2 * s];
    bool committed = false, aborted = false, prepared = false;
    bool all_committed = true, all_aborted = true;
    for (int rm = 0; rm < n; ++rm) {
      const uint32_t rs = (w0 >> (2 * rm)) & 3u;
      committed |= rs == 2u;
      aborted |= rs == 3u;
      prepared |= rs == 1u;
      all_committed &= rs == 2u;
      all_aborted &= rs == 3u;
    }
    conds[p * s] = all_aborted ? 1 : 0;
    conds[p * s + 1] = all_committed ? 1 : 0;
    conds[p * s + 2] = (aborted && committed) ? 0 : 1;
    if (some_prepared) conds[p * s + 3] = prepared ? 1 : 0;
  }
}

}  // namespace

extern "C" int sr_twophase_conds(const uint32_t* states, int64_t f, int n,
                                 int some_prepared, uint8_t* conds,
                                 cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  twophase_conds_kernel<<<sr::grid_for(f, kThreads), kThreads, 0, stream>>>(
      states, f, n, some_prepared, conds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sr_twophase_step(const uint32_t* states, int64_t f, int n,
                                uint32_t* nexts, uint8_t* valid,
                                uint8_t* conds, cudaStream_t stream) {
  if (f <= 0) return 0;
  constexpr int kThreads = 256;
  const int64_t lanes = f * (2 + 5 * n);
  twophase_step_kernel<<<sr::grid_for(lanes, kThreads), kThreads, 0,
                         stream>>>(states, f, n, nexts, valid, conds);
  return static_cast<int>(cudaGetLastError());
}
