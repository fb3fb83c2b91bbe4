// Kernel C: gather-table node sum
//
//   out[a, f] = sum_w src[tbl[a, w], f]   for a < m,   out[m, :] = 0
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
