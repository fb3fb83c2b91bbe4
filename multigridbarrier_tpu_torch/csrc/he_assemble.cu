// Kernel A: batched element Hessian assembly
//
//   He[e] = sum_{q,j} P[e,q,j,:]^T T[e,q,j,:],   T[e,q,j,:] = sum_l W[e,q,j,l] P[e,q,l,:]
//
// Replaces multigridbarrier_tpu/runtime/pallas_kernels.py:assemble_he_pallas
// (kernel body _make_he_kernel), which the JAX package runs for f32 only and
// pads to (8, 128) TPU tiles, one element per grid step.  This kernel covers
// float64 (the main-path dtype) and float32.
//
// What bounds it on an H100: per element it reads nq*k*C + nq*k*k values and
// writes C*C, for 2*nq*k*C*(k + C) flops — at fem2d shapes (nq=7, k=4, C=12)
// about 450 values in, 144 out and 4.3k flops, i.e. ~1.4 flop per byte: a
// memory- and launch-bound op far below the FP64 roofline's ridge.
//
// Design: one CTA takes a block of `epb` consecutive elements, whose P and W
// rows are contiguous in device memory, and stages them into shared memory
// with coalesced loads.  The CTA forms T = W P for the block in shared
// memory, then each thread owns one (c, d) entry of one element and sums
// its nq*k-long dot product in a register, writing He coalesced.  The full
// C x C block is computed (no symmetry shortcut: W is symmetric only to
// round-off, and the kernel must match its plain version).  Sizes: C <= 32,
// nq*k <= 64, and the staged block must fit 48 KB of shared memory; the
// Python wrapper checks these and raises above them.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void he_assemble_kernel(const T* __restrict__ P,
                                   const T* __restrict__ W, T* __restrict__ He,
                                   int64_t nelem, int nq, int k, int C,
                                   int epb) {
  extern __shared__ unsigned char smem_raw[];
  const int qk = nq * k;
  const int pe = qk * C;  // P (and T) values per element
  const int we = qk * k;  // W values per element
  const int cc = C * C;
  T* sP = reinterpret_cast<T*>(smem_raw);
  T* sW = sP + epb * pe;
  T* sT = sW + epb * we;

  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * epb;
  const int64_t left = nelem - e0;
  const int ne = left < epb ? static_cast<int>(left) : epb;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  const T* gP = P + e0 * pe;
  const T* gW = W + e0 * we;
  for (int i = tid; i < ne * pe; i += nth) sP[i] = gP[i];
  for (int i = tid; i < ne * we; i += nth) sW[i] = gW[i];
  __syncthreads();

  // T[es, q, j, d] = sum_l W[es, q, j, l] * P[es, q, l, d]
  for (int i = tid; i < ne * pe; i += nth) {
    const int es = i / pe;
    const int r = i - es * pe;
    const int qj = r / C;
    const int d = r - qj * C;
    const int q = qj / k;
    const T* w = sW + es * we + qj * k;
    const T* p = sP + es * pe + q * k * C + d;
    T acc = T(0);
    for (int l = 0; l < k; ++l) acc += w[l] * p[l * C];
    sT[i] = acc;
  }
  __syncthreads();

  // He[es, c, d] = sum_{qj} P[es, qj, c] * T[es, qj, d]
  for (int i = tid; i < ne * cc; i += nth) {
    const int es = i / cc;
    const int r = i - es * cc;
    const int c = r / C;
    const int d = r - c * C;
    const T* p = sP + es * pe + c;
    const T* t = sT + es * pe + d;
    T acc = T(0);
    for (int qj = 0; qj < qk; ++qj) acc += p[qj * C] * t[qj * C];
    He[(e0 + es) * cc + r] = acc;
  }
}

constexpr size_t kSmemLimit = 48 * 1024;

template <typename T>
int launch(const void* P, const void* W, void* He, int64_t nelem, int nq,
           int k, int C, void* stream) {
  if (nelem <= 0) return 0;
  const size_t per_elem =
      static_cast<size_t>(2 * nq * k * C + nq * k * k) * sizeof(T);
  int epb = 256 / (C * C);
  if (epb < 1) epb = 1;
  while (epb > 1 && epb * per_elem > kSmemLimit) --epb;
  if (epb * per_elem > kSmemLimit || C * C > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = ((epb * C * C + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const int64_t blocks = (nelem + epb - 1) / epb;
  he_assemble_kernel<T><<<static_cast<unsigned>(blocks), threads,
                          epb * per_elem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(W), static_cast<T*>(He),
      nelem, nq, k, C, epb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mgb_he_assemble_f64(const void* P, const void* W, void* He,
                                   int64_t nelem, int nq, int k, int C,
                                   void* stream) {
  return launch<double>(P, W, He, nelem, nq, k, C, stream);
}

extern "C" int mgb_he_assemble_f32(const void* P, const void* W, void* He,
                                   int64_t nelem, int nq, int k, int C,
                                   void* stream) {
  return launch<float>(P, W, He, nelem, nq, k, C, stream);
}
