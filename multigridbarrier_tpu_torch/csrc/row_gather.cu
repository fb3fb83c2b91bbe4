// Kernel D: row gather, two entries
//
//   row_gather:       out[r, l] = v[clamp(idx[r]), l]
//   take_along_rows:  out[r, l] = v[clamp(idx[r, l]), l]
//
// with clamp(j) = min(max(j, 0), n - 1), the probe's mode="clip", so that a
// stray index cannot read outside v.  Replaces
// tools/probe_pallas_gather.py:pallas_take (line 83, kernel body k_take)
// and pallas_tala (line 58, k_tala, the take_along_axis form with the index
// broadcast to the output shape).  In the port row_gather carries every
// gather of the nested-dissection fine level: the front-assembly source
// gather (matrix values and children's Schur entries in one index list),
// the two triangular sweeps' right-hand-side gathers, and the pair-block
// matvec of the CG polish.
//
// What bounds it on an H100: it is pure data movement, one read of each
// output element's source, one index per row and one write — bytes over
// 3.35 TB/s, at zero arithmetic.
//
// Design: rows of at least 8 lanes take a (32, 8) block, threads along the
// lane axis, so neighbouring threads read and write neighbouring addresses
// and the loads coalesce when lanes >= 32; each thread loads its row's
// index once and strides over the row.  Narrow rows (lanes <= 4: the ND
// path's scalar gathers and its nf = 2 node rows) take one thread per row,
// which reads the whole row.  take_along_rows has an index per element, so
// it is one thread per element.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ int64_t clip(int64_t j, int64_t n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

template <typename T>
__global__ void row_gather_narrow(const T* __restrict__ v,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ out, int64_t rows,
                                  int64_t n, int lanes) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* src = v + clip(idx[r], n) * lanes;
  T* dst = out + r * lanes;
  for (int l = 0; l < lanes; ++l) dst[l] = src[l];
}

template <typename T>
__global__ void row_gather_wide(const T* __restrict__ v,
                                const int32_t* __restrict__ idx,
                                T* __restrict__ out, int64_t rows, int64_t n,
                                int lanes) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const T* src = v + clip(idx[r], n) * lanes;
  T* dst = out + r * lanes;
  for (int l = threadIdx.x; l < lanes; l += blockDim.x) dst[l] = src[l];
}

template <typename T>
__global__ void take_along_rows_kernel(const T* __restrict__ v,
                                       const int32_t* __restrict__ idx,
                                       T* __restrict__ out, int64_t total,
                                       int64_t n, int lanes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t l = i % lanes;
  out[i] = v[clip(idx[i], n) * lanes + l];
}

template <typename T>
int launch_rows(const void* v, const int32_t* idx, void* out, int64_t rows,
                int64_t n, int lanes, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes <= 4) {
    const int threads = 256;
    const int64_t blocks = (rows + threads - 1) / threads;
    row_gather_narrow<T><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const T*>(v), idx, static_cast<T*>(out), rows, n, lanes);
  } else {
    const dim3 threads(32, 8);
    const int64_t blocks = (rows + threads.y - 1) / threads.y;
    row_gather_wide<T><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const T*>(v), idx, static_cast<T*>(out), rows, n, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_along(const void* v, const int32_t* idx, void* out, int64_t rows,
                 int64_t n, int lanes, void* stream) {
  const int64_t total = rows * lanes;
  if (total <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  take_along_rows_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(v), idx, static_cast<T*>(out), total, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mgb_row_gather_f64(const void* v, const int32_t* idx,
                                  void* out, int64_t rows, int64_t n,
                                  int lanes, void* stream) {
  return launch_rows<double>(v, idx, out, rows, n, lanes, stream);
}

extern "C" int mgb_row_gather_f32(const void* v, const int32_t* idx,
                                  void* out, int64_t rows, int64_t n,
                                  int lanes, void* stream) {
  return launch_rows<float>(v, idx, out, rows, n, lanes, stream);
}

extern "C" int mgb_take_along_rows_f64(const void* v, const int32_t* idx,
                                       void* out, int64_t rows, int64_t n,
                                       int lanes, void* stream) {
  return launch_along<double>(v, idx, out, rows, n, lanes, stream);
}

extern "C" int mgb_take_along_rows_f32(const void* v, const int32_t* idx,
                                       void* out, int64_t rows, int64_t n,
                                       int lanes, void* stream) {
  return launch_along<float>(v, idx, out, rows, n, lanes, stream);
}
