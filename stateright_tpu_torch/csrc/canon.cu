// K15: symmetry canonicalization of packed rows.
//
// Replaces stateright_tpu/parallel/canon.py:182 canonicalize (with :168
// _extract), vmapped over a wave's rows: the n records of a row's
// symmetric block are stably sorted by their non-Id fields in declaration
// order, the permutation is applied to every per-record field, and Id
// values (per-record Id fields and the global Id fields) are remapped
// old index -> new index; values >= n pass unchanged.
//
// Design: one thread per row.  Each record's sort key is the bit string of
// its key fields, first field most significant, packed into KC 64-bit
// words (KC = 1 up to 64 key bits, else 2); comparing those words as
// unsigned integers orders the records lexicographically by field, u32
// values >= 2**31 included.  A record's new index is its rank: the records
// with a smaller key, or an equal key and a lower index -- the stable
// sort's permutation, mapping[old] = rank[old], without a sort.  Every loop
// over records runs to the compile-time cap with a guard, fully unrolled,
// so keys and ranks stay in registers.  Values are re-read from the input
// row when they are written back: old record i's value lands at new index
// rank[i].  A bit-packed field clears its whole span and ORs the permuted
// values back in once; the global Id fields are read after the record
// fields are written, as in the JAX code.
//
// Bound: bytes.  Each row is read once and written once (2pc: 8 bytes
// each way); a record costs a few dozen integer operations, n**2 key
// comparisons a row.
#include "sr_common.cuh"

namespace {

constexpr int kMaxRecords = 16;
constexpr int kMaxFields = 4;
constexpr int kMaxIds = 4;

struct Field {
  int word, shift, width, bit_stride, word_stride, is_id;
};

struct Spec {
  int n, nf, nid;
  Field f[kMaxFields];
  Field id[kMaxIds];
};

__device__ __forceinline__ uint32_t field_mask(int width) {
  return width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
}

__device__ __forceinline__ uint32_t extract(const uint32_t* row, const Field& f,
                                            int i) {
  return (row[f.word + i * f.word_stride] >> (f.shift + i * f.bit_stride)) &
         field_mask(f.width);
}

// rank[v] for a record index v < n, else v itself.
__device__ __forceinline__ uint32_t remap(uint32_t v, int n,
                                          const int (&rank)[kMaxRecords]) {
  uint32_t r = v;
#pragma unroll
  for (int j = 0; j < kMaxRecords; ++j) {
    if (j < n && v == static_cast<uint32_t>(j)) r = static_cast<uint32_t>(rank[j]);
  }
  return r;
}

template <int KC>
__global__ void canon_kernel(const uint32_t* __restrict__ in, int64_t b, int w,
                             Spec spec, uint32_t* __restrict__ out) {
  const int n = spec.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < b; r += stride) {
    const uint32_t* row = in + r * w;
    uint32_t* o = out + r * w;
    for (int k = 0; k < w; ++k) o[k] = row[k];

    // Sort keys: the key fields' bits, first field most significant.
    uint64_t key[KC][kMaxRecords];
#pragma unroll
    for (int i = 0; i < kMaxRecords; ++i) {
      uint64_t hi = 0, lo = 0;
      if (i < n) {
#pragma unroll
        for (int fi = 0; fi < kMaxFields; ++fi) {
          if (fi < spec.nf && !spec.f[fi].is_id) {
            const int wd = spec.f[fi].width;
            const uint64_t v = extract(row, spec.f[fi], i);
            if constexpr (KC == 2) hi = (hi << wd) | (lo >> (64 - wd));
            lo = (lo << wd) | v;
          }
        }
      }
      key[KC - 1][i] = lo;
      if constexpr (KC == 2) key[0][i] = hi;
    }

    // rank[i]: records before i in the stable order.
    int rank[kMaxRecords];
#pragma unroll
    for (int i = 0; i < kMaxRecords; ++i) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < kMaxRecords; ++j) {
        if (j < n && j != i) {
          bool less;
          if constexpr (KC == 2) {
            less = key[0][j] < key[0][i] ||
                   (key[0][j] == key[0][i] &&
                    (key[1][j] < key[1][i] || (key[1][j] == key[1][i] && j < i)));
          } else {
            less = key[0][j] < key[0][i] || (key[0][j] == key[0][i] && j < i);
          }
          c += less ? 1 : 0;
        }
      }
      rank[i] = c;
    }

    // Every per-record field, permuted (Id values remapped).
#pragma unroll
    for (int fi = 0; fi < kMaxFields; ++fi) {
      if (fi >= spec.nf) continue;
      const Field f = spec.f[fi];
      const uint32_t mask = field_mask(f.width);
      if (f.word_stride == 0) {
        uint64_t clear = 0, bits = 0;
#pragma unroll
        for (int i = 0; i < kMaxRecords; ++i) {
          if (i < n) {
            uint32_t v = extract(row, f, i);
            if (f.is_id) v = remap(v, n, rank);
            clear |= static_cast<uint64_t>(mask) << (f.shift + i * f.bit_stride);
            bits |= static_cast<uint64_t>(v)
                    << (f.shift + rank[i] * f.bit_stride);
          }
        }
        o[f.word] = (o[f.word] & ~static_cast<uint32_t>(clear)) |
                    static_cast<uint32_t>(bits);
      } else {
        const uint32_t m = mask << f.shift;
#pragma unroll
        for (int i = 0; i < kMaxRecords; ++i) {
          if (i < n) {
            uint32_t v = extract(row, f, i);
            if (f.is_id) v = remap(v, n, rank);
            uint32_t* dst = o + f.word + rank[i] * f.word_stride;
            *dst = (*dst & ~m) | (v << f.shift);
          }
        }
      }
    }
    // The global Id fields, read from the record-permuted row.
#pragma unroll
    for (int gi = 0; gi < kMaxIds; ++gi) {
      if (gi >= spec.nid) continue;
      const Field g = spec.id[gi];
      const uint32_t mask = field_mask(g.width);
      const uint32_t val = (o[g.word] >> g.shift) & mask;
      const uint32_t nv = remap(val, n, rank);
      o[g.word] = (o[g.word] & ~(mask << g.shift)) | (nv << g.shift);
    }
  }
}

}  // namespace

// in, out: b rows of w words.  spec: n, the field count, the Id field
// count, then six words (word, shift, width, bit_stride, word_stride,
// is_id) per field and per Id field, len words in all (host memory).
// Returns cudaErrorInvalidValue for a spec past the caps; the caller
// handles the identity spec (n <= 1 or no fields) without a launch.
extern "C" int sr_canonicalize(const uint32_t* in, int64_t b, int w,
                               const int32_t* words, int len, uint32_t* out,
                               cudaStream_t stream) {
  if (len < 3) return static_cast<int>(cudaErrorInvalidValue);
  Spec spec{};
  spec.n = words[0];
  spec.nf = words[1];
  spec.nid = words[2];
  if (spec.n < 0 || spec.n > kMaxRecords || spec.nf < 0 || spec.nf > kMaxFields ||
      spec.nid < 0 || spec.nid > kMaxIds || len != 3 + 6 * (spec.nf + spec.nid))
    return static_cast<int>(cudaErrorInvalidValue);
  int key_bits = 0;
  for (int k = 0; k < spec.nf + spec.nid; ++k) {
    const int32_t* p = words + 3 + 6 * k;
    Field f{p[0], p[1], p[2], p[3], p[4], p[5]};
    if (k < spec.nf) {
      spec.f[k] = f;
      if (!f.is_id) key_bits += f.width;
    } else {
      spec.id[k - spec.nf] = f;
    }
  }
  if (b <= 0) return 0;
  constexpr int kThreads = 128;
  const unsigned grid = sr::grid_for(b, kThreads);
  if (key_bits <= 64) {
    canon_kernel<1><<<grid, kThreads, 0, stream>>>(in, b, w, spec, out);
  } else {
    canon_kernel<2><<<grid, kThreads, 0, stream>>>(in, b, w, spec, out);
  }
  return static_cast<int>(cudaGetLastError());
}
