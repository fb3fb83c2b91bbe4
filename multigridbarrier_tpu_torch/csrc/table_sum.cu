// Kernel C: gather-table sums, three entries
//
//   table_sum:     out[a, f] = sum_w src[tbl[a, w], f]   for a < m,   out[m, :] = 0
//   segment_sum:   out[a, f] = sum_{off[a] <= j < off[a+1]} src[list[j], f]
//                  (list absent: src[j, f])
//   segment_add_:  dst[ids[a], f] += the same sum, for a < nseg, in place
//
// Entries of tbl or list outside [0, rows) (the table's sentinel, rows =
// nelem*nl) read as zero.  Replaces tools/probe_pallas_gather.py:pallas_tblsum
// (kernel body k_tblsum), which is the scatter_idx branch of
// multigridbarrier_tpu/solver/linsolve.py:_node_sum.  In the port table_sum
// is the second half of hvp, and on its own it serves
// LevelBasis.scatter_add (the gradient scatter of every Newton step) and
// diag_of.
//
// What bounds table_sum on an H100: one table row (width 6 at fem2d) and
// `width` gathered values per output, one add each — purely memory- and
// launch-bound, with m+1 <= 16k rows at fem2d L <= 7.  Design: one thread
// per (node, field) output, threads along the contiguous field axis so
// writes coalesce; the sum runs in the table's order in a register.  No
// atomics, so the result is deterministic, and the pad row m is written as
// zero.
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

template <typename T>
__global__ void table_sum_kernel(const T* __restrict__ src,
                                 const int32_t* __restrict__ tbl,
                                 T* __restrict__ out, int64_t rows, int64_t m,
                                 int width, int f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= (m + 1) * f) return;
  const int64_t a = i / f;
  const int col = static_cast<int>(i - a * f);
  T acc = T(0);
  if (a < m) {
    const int32_t* row = tbl + a * width;
    for (int w = 0; w < width; ++w) {
      const int64_t j = row[w];
      if (j >= 0 && j < rows) acc += src[j * f + col];
    }
  }
  out[i] = acc;
}

template <typename T>
int launch(const void* src, const int32_t* tbl, void* out, int64_t rows,
           int64_t m, int width, int f, void* stream) {
  const int64_t total = (m + 1) * f;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  table_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), tbl, static_cast<T*>(out), rows, m, width,
      f);
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
  return launch<double>(src, tbl, out, rows, m, width, f, stream);
}

extern "C" int mgb_table_sum_f32(const void* src, const int32_t* tbl,
                                 void* out, int64_t rows, int64_t m,
                                 int width, int f, void* stream) {
  return launch<float>(src, tbl, out, rows, m, width, f, stream);
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
