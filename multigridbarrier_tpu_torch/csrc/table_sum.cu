// Kernel C: gather-table sums, two entries
//
//   table_sum:    out[a, f] = sum_w src[tbl[a, w], f]   for a < m,   out[m, :] = 0
//   segment_sum:  out[a, f] = sum_{off[a] <= j < off[a+1]} src[list[j], f]
//                 (list absent: src[j, f])
//
// Entries of tbl outside [0, rows) (the table's sentinel, rows = nelem*nl)
// read as zero.  Replaces tools/probe_pallas_gather.py:pallas_tblsum (kernel
// body k_tblsum), which is the scatter_idx branch of
// multigridbarrier_tpu/solver/linsolve.py:_node_sum.  In the port it is the
// second half of hvp, and on its own it serves LevelBasis.scatter_add (the
// gradient scatter of every Newton step) and diag_of.
//
// What bounds it on an H100: one table row (width 6 at fem2d) and `width`
// gathered values per output, one add each — purely memory- and
// launch-bound, with m+1 <= 16k rows at fem2d L <= 7.
//
// Design: one thread per (node, field) output, threads along the
// contiguous field axis so writes coalesce; the sum runs in the table's
// order in a register.  No atomics, so the result is deterministic, and the
// pad row m is written as zero.
//
// segment_sum is the CSR-offset form of the same gather sum, for sums whose
// fan-in is skewed, where a padded table would be mostly sentinel: the host
// sorts the source positions by destination (stably, so each segment keeps
// the order a sequential scatter-add would use) and keeps one offset per
// destination.  It reduces element Hessians to the deduplicated value array
// (fan-in 1 to ~6), assembles the nested-dissection fronts from matrix
// values, children's Schur entries and pad unit diagonals (fan-in up to 34
// at fem2d L=7 against a mean of 2.1, where a width-34 table over 23.5 M
// front entries would cost ~3 GB of int32), and sums the forward sweep's
// boundary updates and the pair-block matvec.  Same design: one thread per
// (destination, field), the segment summed in order in a register, no
// atomics; bounded by the bytes of src, list, off and out.

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

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ src,
                                   const int32_t* __restrict__ list,
                                   const int32_t* __restrict__ off,
                                   T* __restrict__ out, int64_t rows,
                                   int64_t nseg, int f) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nseg * f) return;
  const int64_t a = i / f;
  const int col = static_cast<int>(i - a * f);
  T acc = T(0);
  for (int64_t j = off[a]; j < off[a + 1]; ++j) {
    const int64_t r = list ? static_cast<int64_t>(list[j]) : j;
    if (r >= 0 && r < rows) acc += src[r * f + col];
  }
  out[i] = acc;
}

template <typename T>
int launch_segments(const void* src, const int32_t* list, const int32_t* off,
                    void* out, int64_t rows, int64_t nseg, int f,
                    void* stream) {
  const int64_t total = nseg * f;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), list, off, static_cast<T*>(out), rows, nseg,
      f);
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

extern "C" int mgb_segment_sum_f64(const void* src, const int32_t* list,
                                   const int32_t* off, void* out, int64_t rows,
                                   int64_t nseg, int f, void* stream) {
  return launch_segments<double>(src, list, off, out, rows, nseg, f, stream);
}

extern "C" int mgb_segment_sum_f32(const void* src, const int32_t* list,
                                   const int32_t* off, void* out, int64_t rows,
                                   int64_t nseg, int f, void* stream) {
  return launch_segments<float>(src, list, off, out, rows, nseg, f, stream);
}
