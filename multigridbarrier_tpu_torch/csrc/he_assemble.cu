// Kernel A: batched element Hessian assembly, two entries
//
//   He[e] = sum_{q,j} P[e,q,j,:]^T T[e,q,j,:],   T[e,q,j,:] = sum_l W[e,q,j,l] P[e,q,l,:]
//
//   he_assemble           W (nelem, nq, k, k) is given;
//   he_assemble_weighted  W[e,q,j,l] = F2[e*nq+q, j, l] * w[e*nq+q] is formed
//                         in the kernel from the raw barrier Hessian rows F2
//                         (n, k, k; its (j, l) block dense in either order)
//                         and the quadrature weights w (n,): one rounded
//                         product, then used like a given W.
//
// Replaces multigridbarrier_tpu/runtime/pallas_kernels.py:assemble_he_pallas
// (kernel body _make_he_kernel), which the JAX package runs for f32 only and
// pads to (8, 128) TPU tiles, one element per grid step.  This kernel covers
// float64 (the main-path dtype) and float32.
//
// What bounds it on an H100: per element it reads nq*k*C + nq*k*k values and
// writes C*C, for 2*nq*k*C*(k + C) flops — at fem2d shapes (nq=7, k=4, C=12)
// 448 values in, 144 out and 4.3k flops, i.e. ~1.4 flop per byte: bytes, far
// below the FP64 ridge.  So the design is about keeping loads in flight and
// the shared-memory traffic per flop low, not about the arithmetic units.
//
// Design.
// * A grid of three CTAs per SM; each CTA loops over blocks of `epb`
//   consecutive elements (10 at the fem2d float64 shape, 16 in float32),
//   sized so that two stages of three CTAs fill the 227 KB of shared memory
//   an SM offers (opted in above 48 KB with cudaFuncSetAttribute).  On an
//   H100 at (8192, 7, 4, 12) in float64, blocks of 5 to 15 elements with 2 to
//   6 CTAs per SM ran within a tenth of each other; one CTA per SM or blocks
//   of 2 to 3 elements were up to twice as slow.
// * Two-stage staging with cp.async: the P and W (or F2 and w) values of a
//   block are contiguous in device memory and are copied in 16-byte pieces
//   (element-sized pieces where a shape or a base pointer is not 16-byte
//   aligned) while the CTA sums the block staged before.
// * Thread (element, d) owns column d of that element's He.  For each (q, j)
//   in ascending order it forms T[q,j,d] = sum_l W[q,j,l] P[q,l,d] in a
//   register (l ascending from zero) and adds P[q,j,c] * T[q,j,d] to its C
//   accumulators: T never goes to shared memory, a row P[q,j,:] is read once
//   per C fused multiply-adds with 16-byte loads, and the column P[q,:,d]
//   once per q.  Every sum keeps the order and the `acc += a * b` form
//   (contracted to one fused multiply-add) of a one-thread-per-entry loop,
//   so the result is the same bit for bit whatever epb or the grid is.
// * Shared-memory strides are padded per element (P: congruent to C modulo
//   the banks, W: to 4 modulo 16 values), so the threads of neighbouring
//   elements in a warp hit different banks in all three access patterns
//   (P column: consecutive; P row and W: one address per element).
// * He is written straight from the accumulators: for each c the threads of
//   an element write C consecutive values (96 bytes at C = 12 in float64,
//   whole 32-byte sectors).
// The full C x C block is computed (no symmetry shortcut: W is symmetric only
// to round-off, and the kernel must match its plain version).  Sizes: C <= 32
// and two stages of one element within the shared memory; the Python wrapper
// checks these and raises above them.  (C, k) = (12, 4) and (6, 3) are
// compiled with the accumulators and the l loop unrolled; other shapes share
// one instantiation with 32 predicated accumulators.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxC = 32;
constexpr int kCtasPerSm = 3;
constexpr int kMaxEpb = 16;
constexpr int kSmemPerSm = 232448;      // 227 KB usable per SM on sm_90
constexpr int kSmemPerCtaReserve = 1024;  // reserved by the CUDA runtime per CTA

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `ne` rows of `len` values each, contiguous in device memory, into
// shared memory rows `stride` values apart.
template <typename T>
__device__ __forceinline__ void stage_rows(T* __restrict__ dst,
                                           const T* __restrict__ src, int ne,
                                           int len, int stride, bool wide) {
  constexpr int V = 16 / sizeof(T);
  if (wide) {
    const int per = len / V;
    for (int i = threadIdx.x; i < ne * per; i += blockDim.x) {
      const int es = i / per;
      const int r = (i - es * per) * V;
      cp_async_16(dst + es * stride + r, src + es * len + r);
    }
  } else {
    for (int i = threadIdx.x; i < ne * len; i += blockDim.x) {
      const int es = i / len;
      const int r = i - es * len;
      cp_async_small<sizeof(T)>(dst + es * stride + r, src + es * len + r);
    }
  }
}

struct Shape {
  int nq, k, C;      // quadrature points, rows of Dz, element dofs
  int epb;           // elements per block
  int sp, sw, sq;    // shared-memory strides per element: P, W, weights
  int wj, wl;        // strides of W's (j, l) block
  int64_t nelem, nblocks;
};

// CT, KT: C and k at compile time (0: at run time, from the shape).
template <typename T, int CT, int KT, bool WEIGHTED>
__global__ void __launch_bounds__(kMaxEpb * kMaxC)
    he_assemble_kernel(const T* __restrict__ P, const T* __restrict__ W,
                       const T* __restrict__ wq, T* __restrict__ He,
                       const Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = 16 / sizeof(T);
  constexpr int CM = CT ? CT : kMaxC;
  constexpr int KM = KT ? KT : 1;
  const int C = CT ? CT : s.C;
  const int nq = s.nq;
  const int k = KT ? KT : s.k;
  const int qk = nq * k;
  const int pe = qk * C;  // P values per element
  const int we = qk * k;  // W values per element
  const int cc = C * C;
  const int stage = s.epb * (s.sp + s.sw + s.sq);
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const bool wide_p = pe % V == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0;
  const bool wide_w = we % V == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;

  auto stage_block = [&](int64_t b, int st) {
    T* sP = smem + st * stage;
    T* sW = sP + s.epb * s.sp;
    const int64_t e0 = b * s.epb;
    const int64_t left = s.nelem - e0;
    const int ne = left < s.epb ? static_cast<int>(left) : s.epb;
    stage_rows(sP, P + e0 * pe, ne, pe, s.sp, wide_p);
    stage_rows(sW, W + e0 * we, ne, we, s.sw, wide_w);
    if (WEIGHTED) {
      stage_rows(sW + s.epb * s.sw, wq + e0 * nq, ne, nq, s.sq, false);
    }
  };

  const int es = threadIdx.x / C;
  const int d = threadIdx.x - es * C;

  int64_t b = blockIdx.x;
  if (b < s.nblocks) stage_block(b, 0);
  cp_async_commit();
  for (int it = 0; b < s.nblocks; b += gridDim.x, ++it) {
    const int64_t nb = b + gridDim.x;
    if (nb < s.nblocks) stage_block(nb, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this block's copies have landed; the next may fly
    __syncthreads();

    const int64_t e0 = b * s.epb;
    const int64_t left = s.nelem - e0;
    const int ne = left < s.epb ? static_cast<int>(left) : s.epb;
    if (es < ne) {
      const T* sP = smem + (it & 1) * stage + es * s.sp;
      const T* sW = smem + (it & 1) * stage + s.epb * s.sp + es * s.sw;
      const T* sQ = smem + (it & 1) * stage + s.epb * (s.sp + s.sw) + es * s.sq;
      T acc[CM];
#pragma unroll
      for (int c = 0; c < CM; ++c) acc[c] = T(0);
      for (int q = 0; q < nq; ++q) {
        const T wgt = WEIGHTED ? sQ[q] : T(0);
        const T* pq = sP + q * k * C + d;  // P[q, l, d] at pq[l * C]
        const T* wm = sW + q * k * k;      // W[q, j, l] at wm[j*wj + l*wl]
        T pcol[KM];  // P[q, :, d], read once for the k rows j
        if constexpr (KT != 0) {
#pragma unroll
          for (int l = 0; l < KT; ++l) pcol[l] = pq[l * C];
        }
#pragma unroll
        for (int j = 0; j < k; ++j) {
          // T[q, j, d] = sum_l W[q, j, l] * P[q, l, d]
          T t = T(0);
#pragma unroll
          for (int l = 0; l < k; ++l) {
            T wv = wm[j * s.wj + l * s.wl];
            if (WEIGHTED) wv = mul_rn(wv, wgt);
            if constexpr (KT != 0) {
              t += wv * pcol[l];
            } else {
              t += wv * pq[l * C];
            }
          }
          // He[c, d] += P[q, j, c] * T[q, j, d]
          const T* prow = sP + (q * k + j) * C;
          if constexpr (CT != 0 && CT % V == 0) {
            T row[CM];
#pragma unroll
            for (int c = 0; c < CM; c += V) {
              if constexpr (sizeof(T) == 8) {
                const double2 v = *reinterpret_cast<const double2*>(prow + c);
                row[c] = v.x;
                row[c + 1] = v.y;
              } else {
                const float4 v = *reinterpret_cast<const float4*>(prow + c);
                row[c] = v.x;
                row[c + 1] = v.y;
                row[c + 2] = v.z;
                row[c + 3] = v.w;
              }
            }
#pragma unroll
            for (int c = 0; c < CM; ++c) acc[c] += row[c] * t;
          } else {
#pragma unroll
            for (int c = 0; c < CM; ++c) {
              if (CT || c < C) acc[c] += prow[c] * t;
            }
          }
        }
      }
      T* out = He + (e0 + es) * cc + d;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (CT || c < C) out[c * C] = acc[c];
      }
    }
    __syncthreads();  // the stage is free for the copies of the next turn
  }
  cp_async_wait<0>();
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Strides, elements per block, threads, grid and shared memory of a launch.
struct Plan {
  Shape s;
  int threads, grid;
  size_t smem;
};

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    count[dev] = n;
  }
  return count[dev];
}

template <typename T>
bool make_plan(int64_t nelem, int nq, int k, int C, bool weighted,
               bool transposed, Plan* out) {
  constexpr int V = 16 / sizeof(T);
  constexpr int banks = 128 / sizeof(T);
  if (nelem < 0 || nq <= 0 || k <= 0 || C <= 0 || C > kMaxC) return false;
  const int pe = nq * k * C;
  const int we = nq * k * k;
  Shape s;
  s.nq = nq, s.k = k, s.C = C, s.nelem = nelem;
  // P: stride congruent to C modulo the banks, so a warp's column reads of
  // neighbouring elements continue each other's banks
  s.sp = round_up(pe + (((C - pe) % banks) + banks) % banks, V);
  s.sw = round_up(we + (((4 - we) % 16) + 16) % 16, V);
  s.sq = weighted ? round_up(nq, V) : 0;
  s.wj = transposed ? 1 : k;
  s.wl = transposed ? k : 1;
  const size_t per_elem = static_cast<size_t>(s.sp + s.sw + s.sq) * sizeof(T);
  // Elements per CTA: as many as let kCtasPerSm CTAs keep two stages each in
  // an SM's shared memory; one CTA per SM if two stages of one element need
  // more than that share.
  int epb = static_cast<int>(
      (kSmemPerSm / kCtasPerSm - kSmemPerCtaReserve) / (2 * per_elem));
  if (epb > kMaxEpb) epb = kMaxEpb;
  if (epb > 1024 / C) epb = 1024 / C;
  if (epb < 1) {
    epb = 1;
    if (2 * per_elem > static_cast<size_t>(kSmemPerSm - kSmemPerCtaReserve)) {
      return false;
    }
  }
  if (nelem > 0 && epb > nelem) epb = static_cast<int>(nelem);
  s.epb = epb;
  s.nblocks = (nelem + epb - 1) / epb;
  out->s = s;
  out->threads = round_up(epb * C, 32);
  out->smem = 2 * epb * per_elem;
  const int64_t cap = static_cast<int64_t>(kCtasPerSm) * sm_count();
  out->grid = static_cast<int>(s.nblocks < cap ? s.nblocks : cap);
  return true;
}

template <typename T, int CT, int KT, bool WEIGHTED>
int launch_as(const Plan& p, const void* P, const void* W, const void* wq,
              void* He, void* stream) {
  auto kernel = he_assemble_kernel<T, CT, KT, WEIGHTED>;
  static size_t opted[64] = {0};  // per device: the dynamic size opted in
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.smem > 48 * 1024 && (dev < 0 || dev >= 64 || opted[dev] < p.smem)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) opted[dev] = p.smem;
  }
  kernel<<<p.grid, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const T*>(W),
      static_cast<const T*>(wq), static_cast<T*>(He), p.s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WEIGHTED>
int launch(const void* P, const void* W, const void* wq, void* He,
           int64_t nelem, int nq, int k, int C, bool transposed,
           void* stream) {
  if (nelem <= 0) return 0;
  Plan p;
  if (!make_plan<T>(nelem, nq, k, C, WEIGHTED, transposed, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (C == 12 && k == 4) return launch_as<T, 12, 4, WEIGHTED>(p, P, W, wq, He, stream);
  if (C == 6 && k == 3) return launch_as<T, 6, 3, WEIGHTED>(p, P, W, wq, He, stream);
  return launch_as<T, 0, 0, WEIGHTED>(p, P, W, wq, He, stream);
}

}  // namespace

extern "C" int mgb_he_assemble_f64(const void* P, const void* W, void* He,
                                   int64_t nelem, int nq, int k, int C,
                                   void* stream) {
  return launch<double, false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

extern "C" int mgb_he_assemble_f32(const void* P, const void* W, void* He,
                                   int64_t nelem, int nq, int k, int C,
                                   void* stream) {
  return launch<float, false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

// F2 (nelem*nq, k, k) with its (j, l) block stored (j, l) (transposed = 0) or
// (l, j) (transposed = 1); w (nelem*nq,).
extern "C" int mgb_he_assemble_weighted_f64(const void* P, const void* F2,
                                            const void* w, void* He,
                                            int64_t nelem, int nq, int k, int C,
                                            int transposed, void* stream) {
  return launch<double, true>(P, F2, w, He, nelem, nq, k, C, transposed != 0,
                              stream);
}

extern "C" int mgb_he_assemble_weighted_f32(const void* P, const void* F2,
                                            const void* w, void* He,
                                            int64_t nelem, int nq, int k, int C,
                                            int transposed, void* stream) {
  return launch<float, true>(P, F2, w, He, nelem, nq, k, C, transposed != 0,
                             stream);
}

// The launch configuration for a shape: out = {elements per CTA, threads per
// CTA, CTAs, dynamic shared memory in bytes per CTA}.  Returns 0, or
// cudaErrorInvalidValue where the kernel does not take the shape.
extern "C" int mgb_he_assemble_config(int elem_size, int64_t nelem, int nq,
                                      int k, int C, int weighted, int64_t* out) {
  Plan p;
  const bool ok = elem_size == 8
                      ? make_plan<double>(nelem, nq, k, C, weighted != 0, false, &p)
                      : make_plan<float>(nelem, nq, k, C, weighted != 0, false, &p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.s.epb;
  out[1] = p.threads;
  out[2] = p.grid;
  out[3] = static_cast<int64_t>(p.smem);
  return 0;
}
