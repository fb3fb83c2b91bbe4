// Kernel A for wide elements: batched element Hessian assembly, two entries
//
//   He[e] = sum_{q,j} P[e,q,j,:]^T T[e,q,j,:],   T[e,q,j,:] = sum_l W[e,q,j,l] P[e,q,l,:]
//
//   he_assemble_wide           W (nelem, nq, k, k) is given;
//   he_assemble_wide_weighted  W[e,q,j,l] = F2[e*nq+q, j, l] * w[e*nq+q] is
//                              formed in the kernel (one rounded product)
//                              from F2 (n, k, k; its (j, l) block dense in
//                              either order) and the weights w (n,).
//
// The same function as he_assemble.cu, and like it the port of
// multigridbarrier_tpu/runtime/pallas_kernels.py:assemble_he_pallas (kernel
// body _make_he_kernel), which takes any (nelem, nq, k, C) and pads C to 128
// lanes.  he_assemble.cu keeps one He column per thread and a whole block of
// elements in shared memory, which ends at C = 32; this kernel takes every
// shape above it: Q3 hexahedra with two to four fields give (nq, k, C) =
// (64, 5, 128), (64, 6, 192), (64, 7, 256), Q2 hexahedra (27, 5, 54).
//
// What bounds it on an H100: at (64, 5, 128) in float64 an element reads
// 320 x 128 values (328 KB, more than an SM's shared memory, so the
// reduction axis (q, j) is walked in pieces) and writes 128 x 128 (131 KB,
// so He is tiled over the threads of several CTAs), for
// 2*nq*k*C*(k + C) = 10.9 Mflop: 24 flop per byte, at the float64 ridge
// (67 TFLOP/s over 3.35 TB/s = 20).  Operations and bytes bound it about
// equally; 64 elements (the 3D problem at L=3) are too few to fill the card.
//
// Design (simple first; no tensor cores, no TMA).
// * One CTA of 256 threads per (element, 64 x 64 tile of He): 4 tiles per
//   element at C = 128, so 64 elements still give 256 CTAs for 132 SMs.
// * The CTA walks the flattened reduction axis g = q*k + j in rounds of 40
//   rows.  For a round it stages the rows P[e,q,j,c0:c0+64] of its tile's
//   rows and forms the rows T[q,j,d0:d0+64] of its tile's columns into
//   shared memory, one thread per T entry (l ascending from zero, P and W
//   read through the read-only cache: the 64 threads of a row read
//   consecutive P values, and W[q,j,l] is one address per row).  Then thread
//   (ty, tx) of the 16 x 16 adds the round's rank-one updates, g ascending,
//   to its 4 x 4 register tile: rows 4 ty .. 4 ty + 3 of the tile and columns
//   2 tx, 2 tx + 1, 32 + 2 tx, 33 + 2 tx, so that its four 16-byte
//   shared-memory loads per 16 fused multiply-adds meet no bank conflict.
//   Rounds of 40 rows and not of one quadrature point (k rows): with the
//   latter, two barriers and a round trip to the L2 come with every 80
//   multiply-adds of a thread (on an H100 at (64, 64, 5, 128) in float64 that
//   took 1.8 times this kernel's device time).
// * k = 4..7 are compiled with the loop over l unrolled; any k and any
//   nq*k run, in 40 KB (float64) of shared memory.  Tile edges are
//   predicated, so any C runs.
// * Every sum keeps the order and the `acc += a * b` form of he_assemble.cu
//   ((q, j) ascending, l ascending from zero, F2 * w one rounded product),
//   so at a shape both kernels take they agree bit for bit, and the result
//   does not depend on the tiling or the rounds.
// The full C x C block is computed (no symmetry shortcut, as there).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;      // edge of a CTA's He tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 4;        // edge of a thread's register tile
constexpr int kRows = 40;      // rows (q, j) of the reduction axis per round

static_assert(kTile == 16 * kSub && kThreads == 16 * 16, "thread tiling");

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// Two consecutive values from shared memory, p on a 2-value boundary.
__device__ __forceinline__ void load2(const double* p, double& a, double& b) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

// KT: k at compile time, which unrolls the sum over l (0: at run time).
// wj, wl: strides of W's (j, l) block.
template <typename T, int KT, bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    he_assemble_wide_kernel(const T* __restrict__ P, const T* __restrict__ W,
                            const T* __restrict__ wq, T* __restrict__ He,
                            int nq, int k_rt, int C, int tiles, int wj, int wl) {
  __shared__ __align__(16) T sP[kRows][kTile];  // P[e, q, j, c0 + x], row g = q*k + j
  __shared__ __align__(16) T sT[kRows][kTile];  // T[e, q, j, d0 + x]
  const int k = KT ? KT : k_rt;
  const int per_elem = tiles * tiles;
  const int64_t e = blockIdx.x / per_elem;
  const int tile = static_cast<int>(blockIdx.x - e * per_elem);
  const int c0 = (tile / tiles) * kTile;
  const int d0 = (tile % tiles) * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int rows = nq * k;

  T acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
#pragma unroll
    for (int i2 = 0; i2 < kSub; ++i2) acc[i][i2] = T(0);
  }

  const T* Pe = P + e * rows * C;
  const T* We = W + e * rows * k;
  for (int r0 = 0; r0 < rows; r0 += kRows) {
    const int rn = rows - r0 < kRows ? rows - r0 : kRows;
    __syncthreads();  // the round before has been read
    for (int i = threadIdx.x; i < rn * kTile; i += kThreads) {
      const int r = i / kTile;
      const int x = i - r * kTile;
      const int g = r0 + r;
      const int q = g / k;
      const int j = g - q * k;
      const int c = c0 + x;
      const int d = d0 + x;
      const T* Pq = Pe + static_cast<int64_t>(q) * k * C;
      sP[r][x] = c < C ? __ldg(Pq + j * C + c) : T(0);
      // T[q, j, d] = sum_l W[q, j, l] * P[q, l, d]
      T t = T(0);
      if (d < C) {
        const T* Wq = We + static_cast<int64_t>(q) * k * k;
        const T wgt = WEIGHTED ? __ldg(wq + e * nq + q) : T(0);
#pragma unroll
        for (int l = 0; l < k; ++l) {
          T wv = __ldg(Wq + j * wj + l * wl);
          if (WEIGHTED) wv = mul_rn(wv, wgt);
          t += wv * __ldg(Pq + l * C + d);
        }
      }
      sT[r][x] = t;
    }
    __syncthreads();
    // He[c, d] += P[q, j, c] * T[q, j, d], (q, j) ascending
#pragma unroll 4
    for (int r = 0; r < rn; ++r) {
      T a[kSub], b[kSub];
      load2(&sP[r][ty * kSub], a[0], a[1]);
      load2(&sP[r][ty * kSub + 2], a[2], a[3]);
      load2(&sT[r][tx * 2], b[0], b[1]);
      load2(&sT[r][kTile / 2 + tx * 2], b[2], b[3]);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
#pragma unroll
        for (int i2 = 0; i2 < kSub; ++i2) acc[i][i2] += a[i] * b[i2];
      }
    }
  }

  T* out = He + e * C * C;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int c = c0 + ty * kSub + i;
#pragma unroll
    for (int i2 = 0; i2 < kSub; ++i2) {
      const int d = d0 + (i2 >> 1) * (kTile / 2) + tx * 2 + (i2 & 1);
      if (c < C && d < C) out[static_cast<int64_t>(c) * C + d] = acc[i][i2];
    }
  }
}

template <typename T, int KT, bool WEIGHTED>
int launch_as(const void* P, const void* W, const void* wq, void* He,
              unsigned blocks, int nq, int k, int C, int tiles, int wj, int wl,
              void* stream) {
  he_assemble_wide_kernel<T, KT, WEIGHTED>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(P), static_cast<const T*>(W),
          static_cast<const T*>(wq), static_cast<T*>(He), nq, k, C, tiles, wj, wl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool WEIGHTED>
int launch(const void* P, const void* W, const void* wq, void* He,
           int64_t nelem, int nq, int k, int C, bool transposed, void* stream) {
  if (nelem <= 0) return 0;
  if (nq <= 0 || k <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (static_cast<int64_t>(C) + kTile - 1) / kTile;
  const int64_t blocks = nelem * tiles * tiles;
  if (blocks > INT32_MAX || static_cast<int64_t>(nq) * k * C > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wj = transposed ? 1 : k;
  const int wl = transposed ? k : 1;
  const unsigned nb = static_cast<unsigned>(blocks);
  const int nt = static_cast<int>(tiles);
  switch (k) {
    case 4:
      return launch_as<T, 4, WEIGHTED>(P, W, wq, He, nb, nq, k, C, nt, wj, wl, stream);
    case 5:
      return launch_as<T, 5, WEIGHTED>(P, W, wq, He, nb, nq, k, C, nt, wj, wl, stream);
    case 6:
      return launch_as<T, 6, WEIGHTED>(P, W, wq, He, nb, nq, k, C, nt, wj, wl, stream);
    case 7:
      return launch_as<T, 7, WEIGHTED>(P, W, wq, He, nb, nq, k, C, nt, wj, wl, stream);
    default:
      return launch_as<T, 0, WEIGHTED>(P, W, wq, He, nb, nq, k, C, nt, wj, wl, stream);
  }
}

}  // namespace

extern "C" int mgb_he_assemble_wide_f64(const void* P, const void* W, void* He,
                                        int64_t nelem, int nq, int k, int C,
                                        void* stream) {
  return launch<double, false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

extern "C" int mgb_he_assemble_wide_f32(const void* P, const void* W, void* He,
                                        int64_t nelem, int nq, int k, int C,
                                        void* stream) {
  return launch<float, false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

// F2 (nelem*nq, k, k) with its (j, l) block stored (j, l) (transposed = 0) or
// (l, j) (transposed = 1); w (nelem*nq,).
extern "C" int mgb_he_assemble_wide_weighted_f64(const void* P, const void* F2,
                                                 const void* w, void* He,
                                                 int64_t nelem, int nq, int k,
                                                 int C, int transposed,
                                                 void* stream) {
  return launch<double, true>(P, F2, w, He, nelem, nq, k, C, transposed != 0, stream);
}

extern "C" int mgb_he_assemble_wide_weighted_f32(const void* P, const void* F2,
                                                 const void* w, void* He,
                                                 int64_t nelem, int nq, int k,
                                                 int C, int transposed,
                                                 void* stream) {
  return launch<float, true>(P, F2, w, He, nelem, nq, k, C, transposed != 0, stream);
}
