// Kernel C: gather-table sums, four entries
//
//   table_sum:     out[a, f] = sum_w src[tbl[a, w], f]   for a < m,   out[m, :] = 0
//   table_sum_em:  the same sum read from the element-major layout the
//                  gradient contraction produces, src (nelem, nf*nl) with
//                  table entry j = e*nl + slot at src[e, f*nl + slot], and
//                  written field-major, out (nf, m+1)
//   segment_sum:   out[a, f] = sum_{off[a] <= j < off[a+1]} src[list[j], f]
//                  (list absent: src[j, f])
//   segment_add_:  dst[ids[a], f] += the same sum, for a < nseg, in place
//
// Entries of tbl or list outside [0, rows) (the table's sentinel, rows =
// nelem*nl) read as zero.  Replaces tools/probe_pallas_gather.py:pallas_tblsum
// (kernel body k_tblsum), which is the scatter_idx branch of
// multigridbarrier_tpu/solver/linsolve.py:_node_sum.  In the port table_sum
// serves LevelBasis.scatter_add (R' y), table_sum_em the gradient scatter of
// every Newton step and diag_of; the node sum of hvp is fused into hvp.cu.
//
// What bounds table_sum on an H100: one table row (width 6 at the fem2d fine
// level, thousands on the coarsest levels, where every element touches the
// same few nodes) and `width` gathered values per output, one add each —
// bytes and latency, with m+1 <= 16k rows at fem2d L <= 7.  Design: a group
// of G lanes of one warp owns an output (G the power of two that covers the
// width, at most 32).  Lane g loads table entry w0 + g (neighbouring lanes
// read neighbouring entries of the row-major table) and gathers its source
// value, so all gathers of a round are in flight together, and the next
// round's are started before this round is added; on rows wider than a warp
// a lane takes four entries a round, G apart.  Then every lane of the group
// adds the round's values in table order (warp shuffles), from zero:
// the sum a one-thread loop over the row gives, bit for bit (a sentinel adds
// +0, which changes nothing).  No atomics; the pad row m is written as zero.
// The two layouts differ only in where a source value and an output lie.
//
// segment_sum is the CSR-offset form of the same gather sum, for sums whose
// fan-in is skewed, where a padded table would be mostly sentinel: the host
// sorts the source positions by destination (stably, so each segment keeps
// the order a sequential scatter-add would use) and keeps one offset per
// destination.  It reduces element Hessians to the deduplicated value array
// (fan-in 1 to 10, and four pad-node slots of 2,574 zero entries each at
// fem2d L=7), assembles each nested-dissection front group straight from
// the source buffer [matrix values | children's Schur entries | 1.0]
// through the group's source list (fan-in up to 34 at fem2d L=7 against a
// mean below 2, and most front entries empty: the largest group has 3.0 M
// entries for 0.37 M sources), and sums the pair-block matvec.
// segment_add_ is the forward sweep's boundary update: only the dofs a
// group touches are listed in ids (sorted, unique), so the update reads one
// offset per touched dof and writes nothing else.
//
// What bounds them: bytes.  Every offset and list entry is read once, every
// destination written once; the gathered reads of src are random 4- or
// 8-byte accesses that mostly hit L2.  There is one add per source.
//
// Design.
// * Every sum runs in list order from zero, whatever its length, so it is
//   the sum a sequential scatter-add gives, bit for bit, and two runs
//   repeat.  (A tree over long runs would be faster still, but no length
//   separates the slots that are read from the pad slots: on the coarse
//   levels a real slot sums hundreds to thousands of elements — 96 to 696
//   at fem2d L=4's levels 0-2 — so a tree changes values the solver reads.)
// * Short runs (at most kLongRun = 64 sources) take one thread per
//   (destination, field).  Neighbouring threads read neighbouring offsets
//   and neighbouring stretches of the list through the read-only path
//   (__ldg); where four list entries lie on a 16-byte boundary inside a
//   run they come in one load, and their four gathers of src are started
//   before the first add.  The adds run in a register.
// * A long run would leave one thread waiting on thousands of dependent
//   gathers while its warp idles (one thread per destination took 0.27 ms
//   for He -> vals at fem2d L=7 on an H100, nearly all of it in four pad
//   runs; this design 0.06 ms).  A thread that meets one
//   flags it (one ballot per warp); after the short runs the whole block
//   takes each flagged run in turn: its 256 threads gather 256 entries at
//   once (coalesced list reads, the gathers in flight together) into
//   shared memory, and thread 0 adds them in list order while the block
//   already gathers the next 256.  Only the adds stay serial.  A run of
//   zeros gives 0 and a run holding NaN gives NaN, as in any order.
// * No atomics anywhere: one thread owns each destination (ids are unique
//   in segment_add_), and dst[i] += s with s summed from zero is the same
//   arithmetic as dst + segment_sum(...).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTableThreads = 128;

constexpr int kWide = 4;  // entries per lane and round on rows wider than a warp

// EM: src is element-major (nelem, f*nl) and out field-major (f, m+1);
// otherwise src is (rows, f) and out (m+1, f).  G = 1 << shift lanes per
// output, U entries per lane and round: a round covers U*G consecutive table
// entries, entry w0 + u*G + g by lane g.
template <typename T, bool EM, int U>
__global__ void __launch_bounds__(kTableThreads)
    table_sum_kernel(const T* __restrict__ src, const int32_t* __restrict__ tbl,
                     T* __restrict__ out, int64_t rows, int64_t m, int width,
                     int f, int nl, int shift) {
  const int G = 1 << shift;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int first = lane - g;  // the group's first lane
  const int64_t o =
      (static_cast<int64_t>(blockIdx.x) * kTableThreads + threadIdx.x) >> shift;
  const bool live = o < (m + 1) * f;
  int64_t a = 0;
  int col = 0;
  if (live) {
    if (EM) {
      col = static_cast<int>(o / (m + 1));
      a = o - col * (m + 1);
    } else {
      a = o / f;
      col = static_cast<int>(o - a * f);
    }
  }
  const bool real = live && a < m;
  const int32_t* row = tbl + a * width;
  auto fetch = [&](int w) -> T {
    if (!real || w >= width) return T(0);
    const int64_t j = __ldg(row + w);
    if (j < 0 || j >= rows) return T(0);
    if (EM) {
      const int e = static_cast<int>(j) / nl;  // 32-bit: j came from the table
      return __ldg(src + static_cast<int64_t>(e) * f * nl + col * nl + (j - e * nl));
    }
    return __ldg(src + j * f + col);
  };
  T acc = T(0);
  T next[U];
#pragma unroll
  for (int u = 0; u < U; ++u) next[u] = fetch(u * G + g);
  for (int w0 = 0; w0 < width; w0 += U * G) {
    T cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = next[u];
      next[u] = fetch(w0 + (U + u) * G + g);  // in flight during the adds
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int l = 0; l < G; ++l) acc += __shfl_sync(0xffffffffu, cur[u], first + l);
    }
  }
  if (live && g == 0) out[o] = acc;
}

int group_shift(int width) {
  int shift = 0;
  while ((1 << shift) < width && shift < 5) ++shift;
  return shift;
}

template <typename T, bool EM>
int launch(const void* src, const int32_t* tbl, void* out, int64_t rows,
           int64_t m, int width, int f, int nl, void* stream) {
  const int64_t total = (m + 1) * f;
  if (total <= 0) return 0;
  const int shift = group_shift(width);
  const int64_t per_block = kTableThreads >> shift;
  const int64_t blocks = (total + per_block - 1) / per_block;
  auto kernel = width > 32 ? table_sum_kernel<T, EM, kWide> : table_sum_kernel<T, EM, 1>;
  kernel<<<static_cast<unsigned>(blocks), kTableThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), tbl, static_cast<T*>(out), rows, m, width, f,
      nl, shift);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLongRun = 64;

template <typename T>
__device__ __forceinline__ T fetch(const T* __restrict__ src, int64_t r,
                                   int64_t rows, int f, int col) {
  return (r >= 0 && r < rows) ? src[r * f + col] : T(0);
}

// One thread's run, summed in list order from zero.
template <typename T>
__device__ __forceinline__ T run_sum(const T* __restrict__ src,
                                     const int32_t* __restrict__ list,
                                     int64_t b, int64_t e, int64_t rows, int f,
                                     int col) {
  T acc = T(0);
  int64_t j = b;
  if (list) {
    while (j < e) {
      if (e - j >= 4 && (reinterpret_cast<uintptr_t>(list + j) & 15) == 0) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(list + j));
        const T v0 = fetch(src, q.x, rows, f, col);
        const T v1 = fetch(src, q.y, rows, f, col);
        const T v2 = fetch(src, q.z, rows, f, col);
        const T v3 = fetch(src, q.w, rows, f, col);
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
        j += 4;
      } else {
        acc += fetch(src, __ldg(list + j), rows, f, col);
        ++j;
      }
    }
  } else {
    for (; j < e; ++j) acc += fetch(src, j, rows, f, col);
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ T entry(const T* __restrict__ src,
                                   const int32_t* __restrict__ list, int64_t j,
                                   int64_t e, int64_t rows, int f, int col) {
  if (j >= e) return T(0);
  const int64_t r = list ? static_cast<int64_t>(__ldg(list + j)) : j;
  return fetch(src, r, rows, f, col);
}

// A long run: the block gathers kThreads entries at a time into s_val, and
// thread 0 adds them in list order while the next entries are in flight.
// Every thread of the block must call it; the sum is valid in thread 0.
template <typename T>
__device__ T block_run_sum(const T* __restrict__ src,
                           const int32_t* __restrict__ list, int64_t b,
                           int64_t e, int64_t rows, int f, int col, T* s_val) {
  T acc = T(0);
  T next = entry(src, list, b + threadIdx.x, e, rows, f, col);
  for (int64_t c = b; c < e; c += kThreads) {
    s_val[threadIdx.x] = next;
    __syncthreads();
    next = entry(src, list, c + kThreads + threadIdx.x, e, rows, f, col);
    if (threadIdx.x == 0) {
      const int n = e - c < kThreads ? static_cast<int>(e - c) : kThreads;
#pragma unroll 8
      for (int k = 0; k < n; ++k) acc += s_val[k];
    }
    __syncthreads();
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const T* __restrict__ src,
                       const int32_t* __restrict__ list,
                       const int32_t* __restrict__ off,
                       const int32_t* __restrict__ ids, T* __restrict__ out,
                       int64_t rows, int64_t nseg, int f) {
  __shared__ unsigned s_long[kWarps];
  __shared__ T s_val[kThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + threadIdx.x;
  bool is_long = false;
  if (i < nseg * f) {
    const int64_t a = i / f;
    const int col = static_cast<int>(i - a * f);
    const int64_t b = __ldg(off + a);
    const int64_t e = __ldg(off + a + 1);
    if (e - b > kLongRun) {
      is_long = true;
    } else {
      const T acc = run_sum(src, list, b, e, rows, f, col);
      if (ids) {
        out[static_cast<int64_t>(__ldg(ids + a)) * f + col] += acc;
      } else {
        out[i] = acc;
      }
    }
  }
  const unsigned flagged = __ballot_sync(0xffffffffu, is_long);
  if ((threadIdx.x & 31) == 0) s_long[threadIdx.x >> 5] = flagged;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    unsigned mask = s_long[w];
    while (mask) {
      const int bit = __ffs(mask) - 1;
      mask &= mask - 1;
      const int64_t k = base + w * 32 + bit;
      const int64_t a = k / f;
      const int col = static_cast<int>(k - a * f);
      const T total = block_run_sum(src, list, __ldg(off + a),
                                    __ldg(off + a + 1), rows, f, col, s_val);
      if (threadIdx.x == 0) {
        if (ids) {
          out[static_cast<int64_t>(__ldg(ids + a)) * f + col] += total;
        } else {
          out[k] = total;
        }
      }
    }
  }
}

template <typename T>
int launch_segments(const void* src, const int32_t* list, const int32_t* off,
                    const int32_t* ids, void* out, int64_t rows, int64_t nseg,
                    int f, void* stream) {
  const int64_t total = nseg * f;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), list, off, ids, static_cast<T*>(out), rows,
      nseg, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mgb_table_sum_f64(const void* src, const int32_t* tbl,
                                 void* out, int64_t rows, int64_t m,
                                 int width, int f, void* stream) {
  return launch<double, false>(src, tbl, out, rows, m, width, f, 1, stream);
}

extern "C" int mgb_table_sum_f32(const void* src, const int32_t* tbl,
                                 void* out, int64_t rows, int64_t m,
                                 int width, int f, void* stream) {
  return launch<float, false>(src, tbl, out, rows, m, width, f, 1, stream);
}

// src (rows / nl, f*nl) element-major -> out (f, m+1) field-major.
extern "C" int mgb_table_sum_em_f64(const void* src, const int32_t* tbl,
                                    void* out, int64_t rows, int64_t m,
                                    int width, int f, int nl, void* stream) {
  return launch<double, true>(src, tbl, out, rows, m, width, f, nl, stream);
}

extern "C" int mgb_table_sum_em_f32(const void* src, const int32_t* tbl,
                                    void* out, int64_t rows, int64_t m,
                                    int width, int f, int nl, void* stream) {
  return launch<float, true>(src, tbl, out, rows, m, width, f, nl, stream);
}

// ids absent: segment_sum writes out[a]; ids given: segment_add_ adds into
// out[ids[a]].
extern "C" int mgb_segment_sum_f64(const void* src, const int32_t* list,
                                   const int32_t* off, const int32_t* ids,
                                   void* out, int64_t rows, int64_t nseg,
                                   int f, void* stream) {
  return launch_segments<double>(src, list, off, ids, out, rows, nseg, f,
                                 stream);
}

extern "C" int mgb_segment_sum_f32(const void* src, const int32_t* list,
                                   const int32_t* off, const int32_t* ids,
                                   void* out, int64_t rows, int64_t nseg,
                                   int f, void* stream) {
  return launch_segments<float>(src, list, off, ids, out, rows, nseg, f,
                                stream);
}
