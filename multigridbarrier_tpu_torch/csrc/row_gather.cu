// Kernel D: row gather, two entries
//
//   row_gather:       out[r, l] = v[clamp(idx[r]), l]
//   take_along_rows:  out[r, l] = v[clamp(idx[r, l]), l]
//
// with clamp(j) = min(max(j, 0), n - 1), the probe's mode="clip", so that a
// stray index cannot read outside v.  Replaces
// tools/probe_pallas_gather.py:pallas_take (line 83, kernel body k_take)
// and pallas_tala (line 58, k_tala, the take_along_axis form with the index
// broadcast to the output shape).  In the port row_gather carries the
// gathers of the nested-dissection fine level: the two triangular sweeps'
// right-hand-side gathers, the pair-block matvec of the CG polish, the pair
// blocks and the Jacobi diagonal taken from the matrix values.  (The front
// assembly reads its sources inside kernel C's segment_sum.)
//
// What bounds it on an H100: it is pure data movement, one read of each
// output element's source, one index per row and one write — bytes over
// 3.35 TB/s, at zero arithmetic.  The card moves bytes fastest as 16 bytes
// a thread with several loads in flight.
//
// Design of row_gather, three paths chosen by the launcher from the row's
// size in bytes and the alignment of v and out:
// * Narrow rows (1 or 2 lanes: every gather of the nested-dissection
//   level).  A thread takes four rows: one 16-byte load of their four
//   indices, four independent gathers in flight, and the four rows leave
//   in 16-byte stores (one for four floats, two for four doubles or
//   float2s, four for double2s).
// * Wide rows whose size is a multiple of 16 bytes, with v and out on
//   16-byte boundaries, move as 16-byte units.  A group of G threads (the
//   power of two that covers the row's units, at most a warp) takes four
//   rows at a time: its first lane loads their four indices in one 16-byte
//   load and broadcasts them by shuffle, every thread then starts its four
//   rows' loads before the first store, and the stores are streaming
//   (st.global.cs), so that a large output does not push the table out of
//   L2 while later rows still read it.
// * Any other row (an odd lane count, an unaligned base) takes the same
//   group kernel with one element per unit: the element loop, inside the
//   kernel.
// take_along_rows has an index per element, so it is one thread per
// element.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows in flight per thread (narrow) or group (wide)

__device__ __forceinline__ int64_t clip(int64_t j, int64_t n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Indices of rows r0 .. r0+3: one 16-byte load where all four exist and lie
// on a 16-byte boundary; a missing row repeats row r0's index.
__device__ __forceinline__ int4 load_idx4(const int32_t* __restrict__ idx,
                                          int64_t r0, int64_t rows) {
  if (r0 + kRows <= rows && aligned16(idx + r0)) {
    return __ldg(reinterpret_cast<const int4*>(idx + r0));
  }
  int4 q;
  q.x = __ldg(idx + r0);
  q.y = r0 + 1 < rows ? __ldg(idx + r0 + 1) : q.x;
  q.z = r0 + 2 < rows ? __ldg(idx + r0 + 2) : q.x;
  q.w = r0 + 3 < rows ? __ldg(idx + r0 + 3) : q.x;
  return q;
}

// Four rows to out[0..3] (on a 16-byte boundary) in 16-byte stores.
__device__ __forceinline__ void store4(float* out, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(float2* out, float2 a, float2 b,
                                       float2 c, float2 d) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(a.x, a.y, b.x, b.y);
  o[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void store4(double* out, double a, double b,
                                       double c, double d) {
  double2* o = reinterpret_cast<double2*>(out);
  o[0] = make_double2(a, b);
  o[1] = make_double2(c, d);
}
__device__ __forceinline__ void store4(double2* out, double2 a, double2 b,
                                       double2 c, double2 d) {
  out[0] = a;
  out[1] = b;
  out[2] = c;
  out[3] = d;
}

// R is one whole row (float, float2, double or double2).
template <typename R>
__global__ void __launch_bounds__(kThreads)
    row_gather_narrow(const R* __restrict__ v, const int32_t* __restrict__ idx,
                      R* __restrict__ out, int64_t rows, int64_t n) {
  const int64_t r0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kRows;
  if (r0 >= rows) return;
  const int4 q = load_idx4(idx, r0, rows);
  const R a = v[clip(q.x, n)];
  const R b = v[clip(q.y, n)];
  const R c = v[clip(q.z, n)];
  const R d = v[clip(q.w, n)];
  if (r0 + kRows <= rows) {
    store4(out + r0, a, b, c, d);
  } else {
    out[r0] = a;
    if (r0 + 1 < rows) out[r0 + 1] = b;
    if (r0 + 2 < rows) out[r0 + 2] = c;
  }
}

// U is the unit a row moves in: int4 (16 bytes) or one element.  `units`
// units make a row; a group of G threads (a power of two, at most 32) takes
// kRows rows at a time.
template <typename U>
__global__ void __launch_bounds__(kThreads)
    row_gather_wide(const U* __restrict__ v, const int32_t* __restrict__ idx,
                    U* __restrict__ out, int64_t rows, int64_t n, int units,
                    int G) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int k0 = static_cast<int>(t % G);
  const int64_t r0 = (t / G) * kRows;
  const bool live = r0 < rows;  // uniform over a group; no early return
                                // before the shuffles
  int4 q = make_int4(0, 0, 0, 0);
  if (live && k0 == 0) q = load_idx4(idx, r0, rows);
  q.x = __shfl_sync(0xffffffffu, q.x, 0, G);
  q.y = __shfl_sync(0xffffffffu, q.y, 0, G);
  q.z = __shfl_sync(0xffffffffu, q.z, 0, G);
  q.w = __shfl_sync(0xffffffffu, q.w, 0, G);
  if (!live) return;
  const U* s0 = v + clip(q.x, n) * units;
  const U* s1 = v + clip(q.y, n) * units;
  const U* s2 = v + clip(q.z, n) * units;
  const U* s3 = v + clip(q.w, n) * units;
  U* dst = out + r0 * units;
  const int nrow = rows - r0 < kRows ? static_cast<int>(rows - r0) : kRows;
  for (int k = k0; k < units; k += G) {
    const U a0 = __ldg(s0 + k);
    const U a1 = __ldg(s1 + k);
    const U a2 = __ldg(s2 + k);
    const U a3 = __ldg(s3 + k);
    __stcs(dst + k, a0);
    if (nrow > 1) __stcs(dst + units + k, a1);
    if (nrow > 2) __stcs(dst + 2 * units + k, a2);
    if (nrow > 3) __stcs(dst + 3 * units + k, a3);
  }
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

template <typename R>
void launch_narrow(const void* v, const int32_t* idx, void* out, int64_t rows,
                   int64_t n, cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kRows;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  row_gather_narrow<R><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const R*>(v), idx, static_cast<R*>(out), rows, n);
}

template <typename U>
void launch_wide(const void* v, const int32_t* idx, void* out, int64_t rows,
                 int64_t n, int units, cudaStream_t s) {
  int G = 1;
  while (G < units && G < 32) G *= 2;
  const int64_t per_block = static_cast<int64_t>(kThreads / G) * kRows;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  row_gather_wide<U><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const U*>(v), idx, static_cast<U*>(out), rows, n, units, G);
}

template <typename T>
struct Row2;
template <>
struct Row2<float> {
  using type = float2;
};
template <>
struct Row2<double> {
  using type = double2;
};

template <typename T>
int launch_rows(const void* v, const int32_t* idx, void* out, int64_t rows,
                int64_t n, int lanes, void* stream) {
  if (rows <= 0 || lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = static_cast<size_t>(lanes) * sizeof(T);
  const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const bool v16 = (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  if (lanes == 1 && out16) {
    launch_narrow<T>(v, idx, out, rows, n, s);
  } else if (lanes == 2 && out16 &&
             reinterpret_cast<uintptr_t>(v) % row_bytes == 0) {
    launch_narrow<typename Row2<T>::type>(v, idx, out, rows, n, s);
  } else if (row_bytes % 16 == 0 && v16 && out16) {
    launch_wide<int4>(v, idx, out, rows, n, static_cast<int>(row_bytes / 16),
                      s);
  } else {
    launch_wide<T>(v, idx, out, rows, n, lanes, s);
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
