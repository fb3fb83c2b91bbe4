// Kernel B: element-local matvec, the first half of the matrix-free H v
//
//   out[e*nl + a, f] = sum_b He[e, f*nl + a, b] * vp[b / nl, idx[e, b % nl]]
//
// Replaces the gather + batched matvec of
// tools/probe_pallas_gather.py:pallas_hvp (kernel body k_hvp), which is
// multigridbarrier_tpu/solver/linsolve.py:hvp in kernel form.  The second
// half, the node sum through the gather table, is kernel C (table_sum.cu);
// the two together are the port's hvp.
//
// What bounds it on an H100: each element reads C*C He values (C = nf*nl),
// gathers C coefficients and writes C results for 2*C*C flops — 0.25 flop
// per byte in float64.  It is memory-bound, and at fem2d sizes (2048 to
// 8192 elements, C = 12) launch-bound.
//
// Design: one CTA takes `epb` consecutive elements.  Their He blocks are
// contiguous, so the CTA stages them into shared memory with coalesced
// loads; each thread gathers one (element, b) coefficient of the padded
// field-major vector vp (pad slot m is zero) into shared memory.  Then each
// thread owns one output row of one element and sums its C products in a
// register.  Every output slot is written by exactly one thread: no atomics,
// deterministic.  Where one element's He block does not fit the 48 KB of
// shared memory (C = 128 in float64: hexahedra), the CTA takes one element,
// stages only the gathered coefficients, and each thread walks its He row in
// device memory, in the same order.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void element_matvec_kernel(const T* __restrict__ He,
                                      const int32_t* __restrict__ idx,
                                      const T* __restrict__ vp,
                                      T* __restrict__ out, int64_t nelem,
                                      int nl, int nf, int64_t mp1, int epb,
                                      int staged) {
  extern __shared__ unsigned char smem_raw[];
  const int C = nf * nl;
  const int cc = C * C;
  T* sH = reinterpret_cast<T*>(smem_raw);
  T* sv = staged ? sH + epb * cc : sH;

  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * epb;
  const int64_t left = nelem - e0;
  const int ne = left < epb ? static_cast<int>(left) : epb;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  const T* gH = He + e0 * cc;
  if (staged) {
    for (int i = tid; i < ne * cc; i += nth) sH[i] = gH[i];
  }
  for (int i = tid; i < ne * C; i += nth) {
    const int es = i / C;
    const int b = i - es * C;
    const int f = b / nl;
    const int a = b - f * nl;
    const int64_t node = idx[(e0 + es) * nl + a];
    sv[i] = vp[f * mp1 + node];
  }
  __syncthreads();

  for (int i = tid; i < ne * C; i += nth) {
    const int es = i / C;
    const int r = i - es * C;
    const T* row = (staged ? sH : gH) + es * cc + r * C;
    const T* v = sv + es * C;
    T acc = T(0);
    for (int b = 0; b < C; ++b) acc += row[b] * v[b];
    const int f = r / nl;
    const int a = r - f * nl;
    out[((e0 + es) * nl + a) * nf + f] = acc;
  }
}

constexpr size_t kSmemLimit = 48 * 1024;

template <typename T>
int launch(const void* He, const int32_t* idx, const void* vp, void* out,
           int64_t nelem, int nl, int nf, int64_t mp1, void* stream) {
  if (nelem <= 0) return 0;
  const int C = nf * nl;
  size_t per_elem = (static_cast<size_t>(C) * C + C) * sizeof(T);
  int epb = 128 / C;
  if (epb < 1) epb = 1;
  while (epb > 1 && epb * per_elem > kSmemLimit) --epb;
  const int staged = epb * per_elem <= kSmemLimit;
  if (!staged) per_elem = static_cast<size_t>(C) * sizeof(T);
  if (C > 1024 || epb * per_elem > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = ((epb * C + 31) / 32) * 32;
  const int64_t blocks = (nelem + epb - 1) / epb;
  element_matvec_kernel<T><<<static_cast<unsigned>(blocks), threads,
                             epb * per_elem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(He), idx, static_cast<const T*>(vp),
      static_cast<T*>(out), nelem, nl, nf, mp1, epb, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mgb_element_matvec_f64(const void* He, const int32_t* idx,
                                      const void* vp, void* out,
                                      int64_t nelem, int nl, int nf,
                                      int64_t mp1, void* stream) {
  return launch<double>(He, idx, vp, out, nelem, nl, nf, mp1, stream);
}

extern "C" int mgb_element_matvec_f32(const void* He, const int32_t* idx,
                                      const void* vp, void* out,
                                      int64_t nelem, int nl, int nf,
                                      int64_t mp1, void* stream) {
  return launch<float>(He, idx, vp, out, nelem, nl, nf, mp1, stream);
}
