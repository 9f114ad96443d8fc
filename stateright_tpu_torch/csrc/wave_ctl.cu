// K29: the fused wave loop's control -- the chunk load, the wave's tail
// (flags, commit, discovery fold, counters, level roll) and the loop
// condition, plus the CUDA graph that runs a quantum of waves on the card.
//
// Replaces stateright_tpu/parallel/wavefront.py:493 _build_run: its carry
// (:516-519), the chunk slice of wave_body (:610-619), the wave_body tail
// (:684-773) and wave_cond (:775-789), run by the lax.while_loop of run()
// (:793-821) between two readbacks of one stats vector (:64-74).
//
// The stats vector is the JAX layout, u32 words: level_start, level_end,
// tail, sc_lo, sc_hi, unique, depth, flags, then disc[P] (NO_ID = none).
// Beside it (not inside it) K29 keeps its own words, read back in the same
// copy: waves_left, go, waves_run, the committed wave's lo_pos, tail and
// appended count (what K25's device entry reads), and K4's claim epoch.
//
// wave_load: states[lane] = rows[level_start + lane] for the active lanes
//   lane < count = min(level_end - level_start, F), and a copy of the
//   chunk's first row for the rest, so a model kernel's reduction over
//   every lane it is given (the encoding-overflow flag) sees only active
//   rows; eb likewise from the ebits log; active[lane] = lane < count.
// wave_ctl: with begin set, the quantum's start: flags = 0, waves_left =
//   the quantum, waves_run = 0, go = the loop condition.  Otherwise one
//   wave's tail, the JAX wave_body's to the bit: flags 1 (probe failure
//   or past half load), 2 (log full), 4 (buffer overflow), 8 (encoding
//   overflow), 128 (the step rung clamped the level); commit = flags == 0;
//   the first-writer-wins discovery fold, sc (64-bit over sc_lo/sc_hi),
//   unique, tail, level_start, the level roll and depth, all gated by
//   commit; waves_left - 1 and waves_run + 1; then go = level_start <
//   level_end, waves_left > 0, flags == 0, depth < target - 1 (when a
//   target is set) and not finish_when -- two masks: every bit of `all`
//   found (a nonzero mask), or any bit of `any` found.
//
// Bound: latency.  wave_load moves the chunk's rows once (4W + 5 bytes a
// lane, read and written); wave_ctl reads and writes a few dozen words.
// Design: wave_load is one thread a word in a grid-stride loop over a grid
// sized at launch for the fixed chunk, level_start read from the stats by
// every thread; wave_ctl is one thread of one block (P <= 32 discovery
// words), a few microseconds, on the card so that no wave waits on the
// host.  The quantum is a CUDA graph: the captured wave is the body of a
// WHILE conditional node whose condition a one-thread kernel sets from
// K29's go word, before the node and at the end of each body run -- the
// lax.while_loop itself, so a stopped quantum runs no further wave.
#include "sr_common.cuh"

namespace {

constexpr uint32_t kNoId = 0xFFFFFFFFu;

enum : int {
  kLevelStart = 0, kLevelEnd, kTail, kScLo, kScHi, kUnique, kDepth, kFlags,
  kDisc
};
// K29's words, after disc[P].
enum : int {
  kWavesLeft = 0, kGo, kWavesRun, kWaveLo, kWaveTail, kWaveNew, kEpoch
};

constexpr int kThreads = 256;

__global__ void wave_load_kernel(const uint32_t* __restrict__ rows,
                                 const uint32_t* __restrict__ ebits,
                                 const uint32_t* __restrict__ stats, int64_t f,
                                 int w, uint32_t* __restrict__ states,
                                 uint32_t* __restrict__ eb,
                                 uint8_t* __restrict__ active) {
  const int64_t ls = stats[kLevelStart];
  const int64_t le = stats[kLevelEnd];
  const int64_t left = le > ls ? le - ls : 0;
  const int64_t count = left < f ? left : f;
  const int64_t words = f * w;
  const int64_t total = words + f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    if (t < words) {
      const int64_t lane = t / w;
      const int64_t k = t - lane * w;
      const int64_t src = lane < count ? lane : 0;
      states[t] = count ? rows[(ls + src) * w + k] : 0u;
    } else {
      const int64_t lane = t - words;
      const int64_t src = lane < count ? lane : 0;
      eb[lane] = count ? ebits[ls + src] : 0u;
      active[lane] = lane < count ? 1 : 0;
    }
  }
}

struct CtlArgs {
  const int64_t* n_new;    // K3's count of the insert's new mask
  const int64_t* n_valid;  // K3's count of the valid lanes (generated)
  const uint8_t* probe_ok;  // K4's probe_ok flag
  const uint8_t* step_flag;  // the step's overflow flag, or null
  const uint8_t* dd_flag;    // the sorted path's distinct overflow, or null
  const unsigned long long* cands;  // K8's first hits, NO_ID for none
  int64_t f_eff, f_full, cap, qcap, size, target;
  uint32_t fw_all, fw_any;
  int p, waves;
};

__device__ bool loop_cond(const uint32_t* stats, const uint32_t* ctl,
                          const CtlArgs& a) {
  bool go = stats[kLevelStart] < stats[kLevelEnd] &&
            static_cast<int32_t>(ctl[kWavesLeft]) > 0 && stats[kFlags] == 0u;
  if (a.target) go = go && static_cast<int64_t>(stats[kDepth]) < a.target - 1;
  uint32_t found = 0;
  for (int q = 0; q < a.p; ++q)
    if (stats[kDisc + q] != kNoId) found |= 1u << q;
  const bool fw = (a.fw_all != 0u && (found & a.fw_all) == a.fw_all) ||
                  (found & a.fw_any) != 0u;
  return go && !fw;
}

__global__ void wave_ctl_kernel(uint32_t* __restrict__ stats, CtlArgs a,
                                int begin) {
  if (threadIdx.x != 0) return;
  uint32_t* ctl = stats + kDisc + a.p;
  if (begin) {
    stats[kFlags] = 0u;
    ctl[kWavesLeft] = static_cast<uint32_t>(a.waves);
    ctl[kWavesRun] = 0u;
    ctl[kWaveNew] = 0u;
    ctl[kGo] = loop_cond(stats, ctl, a) ? 1u : 0u;
    return;
  }
  const int64_t ls = stats[kLevelStart];
  const int64_t le = stats[kLevelEnd];
  const int64_t tail = stats[kTail];
  const int64_t unique = stats[kUnique];
  const int64_t n_new = *a.n_new;
  const int64_t generated = *a.n_valid;
  uint32_t flags = stats[kFlags];
  if (!*a.probe_ok || (unique + n_new) * 2 > a.cap) flags |= 1u;
  if (tail + n_new > a.qcap) flags |= 2u;
  if (generated > a.size || (a.dd_flag != nullptr && *a.dd_flag)) flags |= 4u;
  if (a.step_flag != nullptr && *a.step_flag) flags |= 8u;
  if (a.f_eff < a.f_full && le - ls > a.f_eff) flags |= 128u;
  const bool commit = flags == 0u;
  const int64_t left = le > ls ? le - ls : 0;
  const int64_t count = commit ? (left < a.f_eff ? left : a.f_eff) : 0;
  const int64_t appended = commit ? n_new : 0;
  if (commit) {
    for (int q = 0; q < a.p; ++q) {
      const unsigned long long c = a.cands[q];
      if (stats[kDisc + q] == kNoId && c != kNoId)
        stats[kDisc + q] = static_cast<uint32_t>(c);
    }
    const uint32_t lo = stats[kScLo];
    const uint32_t sum = lo + static_cast<uint32_t>(generated);
    stats[kScLo] = sum;
    stats[kScHi] += sum < lo ? 1u : 0u;
    stats[kUnique] = static_cast<uint32_t>(unique + appended);
    stats[kTail] = static_cast<uint32_t>(tail + appended);
    stats[kLevelStart] = static_cast<uint32_t>(ls + count);
    if (ls + count >= le) {
      stats[kDepth] += 1u;
      stats[kLevelEnd] = static_cast<uint32_t>(tail + appended);
    }
  }
  stats[kFlags] = flags;
  ctl[kWaveLo] = static_cast<uint32_t>(ls);
  ctl[kWaveTail] = static_cast<uint32_t>(tail);
  ctl[kWaveNew] = static_cast<uint32_t>(appended);
  ctl[kWavesLeft] -= 1u;
  ctl[kWavesRun] += 1u;
  ctl[kGo] = loop_cond(stats, ctl, a) ? 1u : 0u;
}

#if CUDART_VERSION >= 12040
__global__ void set_cond_kernel(cudaGraphConditionalHandle handle,
                                const uint32_t* go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}
#endif

}  // namespace

// rows: the row log; ebits: its eventually-bits; stats: the stats vector;
// states: F * w words, eb: F words, active: F bytes, all written.
extern "C" int sr_wave_load(const uint32_t* rows, const uint32_t* ebits,
                            const uint32_t* stats, int64_t f, int w,
                            uint32_t* states, uint32_t* eb, uint8_t* active,
                            cudaStream_t stream) {
  if (f <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  wave_load_kernel<<<sr::grid_for(f * (w + 1), kThreads), kThreads, 0,
                     stream>>>(rows, ebits, stats, f, w, states, eb, active);
  return static_cast<int>(cudaGetLastError());
}

// stats: 8 + p + 7 words (the stats vector, then K29's words).  With begin
// the count pointers may be null.  step_flag and dd_flag may be null.
extern "C" int sr_wave_ctl(uint32_t* stats, int p, const int64_t* n_new,
                           const int64_t* n_valid, const uint8_t* probe_ok,
                           const uint8_t* step_flag, const uint8_t* dd_flag,
                           const unsigned long long* cands, int64_t f_eff,
                           int64_t f_full, int64_t cap, int64_t qcap,
                           int64_t size, int64_t target, uint32_t fw_all,
                           uint32_t fw_any, int waves, int begin,
                           cudaStream_t stream) {
  if (p < 0 || p > 32) return static_cast<int>(cudaErrorInvalidValue);
  CtlArgs a{n_new, n_valid, probe_ok, step_flag, dd_flag, cands, f_eff,
            f_full, cap, qcap, size, target, fw_all, fw_any, p, waves};
  wave_ctl_kernel<<<1, 32, 0, stream>>>(stats, a, begin);
  return static_cast<int>(cudaGetLastError());
}

// The CUDA runtime's and the driver's versions (e.g. 12040 for 12.4).
extern "C" int sr_cuda_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e == cudaSuccess) e = cudaDriverGetVersion(driver);
  return static_cast<int>(e);
}

// The quantum's graph: a WHILE conditional node around a child copy of the
// captured wave `body` (a cudaGraph_t), its condition set from *go by a
// one-thread kernel before the node and after each body run.  Writes the
// instantiated executable to *exec_out.  cudaErrorNotSupported where the
// toolkit predates conditional WHILE nodes (CUDA 12.4).
extern "C" int sr_while_graph(void* body, const uint32_t* go, void** exec_out) {
#if CUDART_VERSION >= 12040
  cudaGraph_t outer = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t e = cudaGraphCreate(&outer, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t set0, cond, child, set1;
  void* args[2];
  cudaKernelNodeParams kp = {};
  cudaGraphNodeParams cp = {};
  cudaGraph_t inner = nullptr;
  e = cudaGraphConditionalHandleCreate(&handle, outer, 0, 0);
  if (e != cudaSuccess) goto done;
  args[0] = &handle;
  args[1] = &go;
  kp.func = reinterpret_cast<void*>(set_cond_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  e = cudaGraphAddKernelNode(&set0, outer, nullptr, 0, &kp);
  if (e != cudaSuccess) goto done;
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  e = cudaGraphAddNode(&cond, outer, &set0, 1, &cp);
  if (e != cudaSuccess) goto done;
  inner = cp.conditional.phGraph_out[0];
  e = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                 static_cast<cudaGraph_t>(body));
  if (e != cudaSuccess) goto done;
  e = cudaGraphAddKernelNode(&set1, inner, &child, 1, &kp);
  if (e != cudaSuccess) goto done;
  e = cudaGraphInstantiate(&exec, outer, 0);
  if (e == cudaSuccess) *exec_out = exec;
done:
  cudaGraphDestroy(outer);
  return static_cast<int>(e);
#else
  (void)body;
  (void)go;
  (void)exec_out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}

extern "C" int sr_graph_launch(void* exec, cudaStream_t stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream);
  return static_cast<int>(e);
}

extern "C" int sr_graph_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
