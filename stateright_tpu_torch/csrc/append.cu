// K25: the wave's append -- the new representatives' rows, parents and
// eventually-bits at the log tail.
//
// Replaces stateright_tpu/parallel/wavefront.py:1666 t_append (the traced
// wave's append program; the fused wave_body's append is the same code):
// for the j-th new representative, j < n_new, its buffer lane is
// lane = sel[j] (K3's compaction of the insert's new mask), taken through
// origin[lane] on the sorted path, and its candidate lane is
// idx = v_orig[lane] (state idx / A of the wave, action idx % A).  Then
//   rows[(tail + j) * W + k] = cand_rows[src * W + k], k < W, where src is
//     the buffer lane itself on two-phase waves (the successors are
//     already compacted) and idx on single-phase waves;
//   parent[tail + j] = lo_pos + idx / A;
//   ebits[tail + j] = eb[idx / A].
// The log, parents and ebits are written in place; nothing else is.
//
// Bound: bytes.  Each new row is read once (4W bytes, gathered) and
// written once (4W, contiguous); each new state's parent and ebits word
// written once and its parent's eventually-bits read once, and the index
// words (sel, origin, v_orig) read once a row.  The arithmetic is a
// division and a few adds a word.
// Design: one thread per output word in a grid-stride loop: threads
// [0, n_new * W) copy row words, so neighbouring threads write
// neighbouring words of the tail block (coalesced writes, gathered reads
// of whole rows); threads [n_new * W, n_new * W + n_new) write a parent
// and an ebits word each.  The index chain is re-read by each word of a
// row and served from L1/L2.  One launch, no scratch, no sync.
//
// The device-count entry (sr_append_block_dev) serves the fused wave loop
// (K29, csrc/wave_ctl.cu): lo_pos, tail and n_new are the three words K29's
// wave_ctl writes for the wave it just closed -- n_new is 0 for a wave
// that did not commit, so an aborted wave appends nothing -- and the grid
// is sized at launch for the widest append the buffer allows, each thread
// reading the live count first.
#include "sr_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t source_lane(
    const uint32_t* __restrict__ sel, const uint32_t* __restrict__ origin,
    int64_t j) {
  int64_t lane = sel[j];
  if (origin != nullptr) lane = origin[lane];
  return lane;
}

__global__ void append_kernel(uint32_t* __restrict__ rows,
                              uint32_t* __restrict__ parent,
                              uint32_t* __restrict__ ebits,
                              const uint32_t* __restrict__ sel,
                              const uint32_t* __restrict__ origin,
                              const uint32_t* __restrict__ v_orig,
                              const uint32_t* __restrict__ cand_rows,
                              const uint32_t* __restrict__ eb,
                              int64_t lo_pos, int64_t tail, int64_t n_new,
                              int a, int w, int two_phase,
                              const uint32_t* __restrict__ wave) {
  if (wave != nullptr) {  // the device-count entry: K29's closed wave
    lo_pos = wave[0];
    tail = wave[1];
    n_new = wave[2];
  }
  const int64_t row_words = n_new * w;
  const int64_t total = row_words + n_new;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    if (t < row_words) {
      const int64_t j = t / w;
      const int64_t k = t - j * w;
      const int64_t lane = source_lane(sel, origin, j);
      const int64_t src = two_phase ? lane : static_cast<int64_t>(v_orig[lane]);
      rows[(tail + j) * w + k] = cand_rows[src * w + k];
    } else {
      const int64_t j = t - row_words;
      const int64_t lane = source_lane(sel, origin, j);
      const int64_t s = static_cast<int64_t>(v_orig[lane]) / a;
      parent[tail + j] = static_cast<uint32_t>(lo_pos + s);
      ebits[tail + j] = eb[s];
    }
  }
}

}  // namespace

// rows: the row log (>= (tail + n_new) * w words); parent, ebits: >= tail +
// n_new words; sel: >= n_new words; origin: the sorted path's buffer-lane
// map, or null; v_orig: the buffer's candidate lanes; cand_rows: the
// successor rows, w words each (compacted on two-phase waves); eb: the
// wave's states' eventually-bits.  a >= 1, w >= 1.
extern "C" int sr_append_block(uint32_t* rows, uint32_t* parent,
                               uint32_t* ebits, const uint32_t* sel,
                               const uint32_t* origin, const uint32_t* v_orig,
                               const uint32_t* cand_rows, const uint32_t* eb,
                               int64_t lo_pos, int64_t tail, int64_t n_new,
                               int a, int w, int two_phase,
                               cudaStream_t stream) {
  if (n_new <= 0) return 0;
  const unsigned grid = sr::grid_for(n_new * (w + 1), kThreads);
  append_kernel<<<grid, kThreads, 0, stream>>>(
      rows, parent, ebits, sel, origin, v_orig, cand_rows, eb, lo_pos, tail,
      n_new, a, w, two_phase, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The device-count entry: as sr_append_block, with (lo_pos, tail, n_new)
// the three words at `wave` and at most n_max (the width of sel) new
// states; the caller's flags kept the append inside the log.
extern "C" int sr_append_block_dev(uint32_t* rows, uint32_t* parent,
                                   uint32_t* ebits, const uint32_t* sel,
                                   const uint32_t* origin,
                                   const uint32_t* v_orig,
                                   const uint32_t* cand_rows,
                                   const uint32_t* eb, const uint32_t* wave,
                                   int64_t n_max, int a, int w, int two_phase,
                                   cudaStream_t stream) {
  if (n_max <= 0) return 0;
  const unsigned grid = sr::grid_for(n_max * (w + 1), kThreads);
  append_kernel<<<grid, kThreads, 0, stream>>>(
      rows, parent, ebits, sel, origin, v_orig, cand_rows, eb, 0, 0, 0, a, w,
      two_phase, wave);
  return static_cast<int>(cudaGetLastError());
}
