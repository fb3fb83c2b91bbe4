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
// elements in shared memory, which ends at C = 32; this kernel takes the
// shapes above it: Q3 hexahedra with two to four fields give (nq, k, C) =
// (64, 5, 128), (64, 6, 192), (64, 7, 256), Q2 hexahedra (27, 5, 54).
//
// What bounds it on an H100: per element He = P^T T is a (C x R) by (R x C)
// product over R = nq*k rows (320 at (64, 5, 128)), 2*nq*k*C*(k + C) flops
// in all: 10.9 Mflop against 459 KB moved at (64, 5, 128), 24 flop per byte,
// above the float64 ridge (67 TFLOP/s over 3.35 TB/s = 20).  So operations
// bound it, and in float64 the card reaches 67 TFLOP/s only in its tensor
// cores (DMMA); the plain float64 pipes peak at half that, 34 TFLOP/s.
//
// float64 design: warp-level DMMA tiles over staged P, warp-specialised.
// * One CTA per (element, 64 x 64 tile of He): 4 tiles per element at
//   C = 128, so 64 elements give 256 CTAs for 132 SMs, two CTAs an SM.
// * The CTA walks the reduction axis in rounds of whole quadrature points
//   (4 at k = 5, 6, 7: 20, 24, 28 rows; a round is a multiple of k and of
//   the MMA depth 4, zero-padded where no such length fits).
// * 4 producer warps stage round p + 1 with cp.async (the A-side rows
//   P[e,q,j,c0:c0+64], the B-side rows P[e,q,l,d0:d0+64], the same buffer on
//   a diagonal tile, and the round's W or F2 and w; 3 stages) and form T of
//   round p into one of two T buffers, also on the tensor cores: per point
//   and half tile, mma.sync m8n8k4 with A = W[q] (zero-padded to 8 x 8,
//   W = F2 * w rounded once as the fragment is loaded), B = P[q, :, half].
// * Meanwhile 4 MMA warps, 32 x 32 of the tile each, multiply round p - 1
//   with mma.sync m16n8k4 float64 (the shape PTX gives sm_90): per depth
//   step of 4 rows, 4 A and 4 B fragment loads (8 bytes a lane) feed 8 DMMA.
//   Named barriers hand the T buffers and stages back and forth, so the
//   staging, the transform and the product of successive rounds overlap.
//   Rows are 68 values apart (64 + 4), so the four rows of a fragment load
//   fall on distinct banks.
// * One CTA per He tile and a fixed round order: no atomics, no split of R
//   over CTAs, so two calls give the same bits.  A DMMA adds the products
//   of its depth in its own order, so float64 results may differ from the
//   narrow kernel's sequential sums in the last bits.
// * Column edges past C are zeroed once and the rows past the last
//   quadrature point in the last round, so any C runs; k is limited only by
//   shared memory (k <= 40).

// float32 keeps the SIMT design (TF32 tensor cores keep about three digits):
// one CTA of 256 threads per (element, 64 x 64 tile), rounds of 40 rows of
// the flattened (q, j) axis staged with T formed into shared memory, 4 x 4
// register tiles with conflict-free 16-byte loads, every sum in the order and
// `acc += a * b` form of he_assemble.cu, so where both kernels take a shape
// they agree bit for bit in float32.
// The full C x C block is computed (no symmetry shortcut, as there).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;  // edge of a CTA's He tile (both designs)

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// ---------------------------------------------------------------------------
// float64: DMMA tiles
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                // MMA warps, 2 x 2 tiles of 32 x 32
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kProd = 128;               // producer threads: 4 warps that stage and transform
constexpr int kThreadsAll = kMmaThreads + kProd;
constexpr int kStages = 3;               // staged rounds
constexpr int kStride = kTile + 4;       // shared-memory row stride, values
constexpr int kDepth = 4;                // rows per MMA step
constexpr int kRowCap = 32;              // most rows in a round
constexpr int kSmemMax = 232448 - 1024;  // an SM's 227 KB less the CTA reserve

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers: bar.sync waits for `n` threads (arrivals included),
// bar.arrive counts without waiting; both order the shared-memory accesses
// before them for the threads that wait.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// D (8 x 8) += A (8 x 4, row) B (4 x 8, col).  Lane = 4 g + t holds A[g][t],
// B[t][g] and D[g][2t], D[g][2t + 1].
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// D (16 x 8) += A (16 x 4, row) B (4 x 8, col): the m16n8k4 float64 shape
// that PTX gives sm_90.  Lane = 4 g + t holds A[g][t], A[g + 8][t], B[t][g]
// and D[g][2t + {0, 1}], D[g + 8][2t + {0, 1}].
__device__ __forceinline__ void dmma_16x8x4(double& d0, double& d1, double& d2, double& d3,
                                            double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

struct Wide {
  int nq, k, C, tiles;
  int qr;           // quadrature points per round
  int rows;         // rows per round, qr*k rounded up to kDepth
  int wj, wl;       // strides of W's (j, l) block
  int stage;        // values per stage: A rows, B rows, W, w
};

// Shared memory per CTA in values: kStages stages, two T buffers.
__host__ __device__ inline int smem_values(const Wide& s) {
  return kStages * s.stage + 2 * s.rows * kStride;
}

// Stage round (q0, qn) of element e: the A-side rows P[q, j, c0 + x] and
// the B-side rows P[q, l, d0 + x] (skipped on a diagonal tile, whose B side
// is its A side), then W (or F2) of the round and, weighted, its w, all by
// cp.async.  Thread i copies columns x = 2 (i % 32), x + 1 of the rows
// i / 32 + 8 m; columns past C stay as zero_edges left them, and rows past
// the round's last point (its last round only) are zeroed here.
template <bool WEIGHTED>
__device__ __forceinline__ void stage_round(const Wide& s, double* buf, const double* __restrict__ P,
                                            const double* __restrict__ W,
                                            const double* __restrict__ wq, int64_t e, int q0,
                                            int qn, int c0, int d0, bool vec, int tid) {
  constexpr int nt = kProd;
  const int real = qn * s.k;
  const int64_t g0 = (e * s.nq + q0) * s.k;  // first row of the round in (nelem*nq*k, C)
  const int x = 2 * (tid & 31);
  const int sides = c0 == d0 ? 1 : 2;
  for (int side = 0; side < sides; ++side) {
    const int c = (side == 0 ? c0 : d0) + x;
    double* dst = buf + side * s.rows * kStride + x;
    const double* src = P + g0 * s.C + c;
    if (vec) {  // C even: c + 1 < C with c
      if (c < s.C) {
        for (int r = tid >> 5; r < real; r += nt / 32) {
          cp_async_16(dst + r * kStride, src + static_cast<int64_t>(r) * s.C);
        }
      }
    } else {
      for (int r = tid >> 5; r < real; r += nt / 32) {
        if (c < s.C) cp_async_8(dst + r * kStride, src + static_cast<int64_t>(r) * s.C);
        if (c + 1 < s.C) cp_async_8(dst + r * kStride + 1, src + static_cast<int64_t>(r) * s.C + 1);
      }
    }
    for (int i = tid; i < (s.rows - real) * kTile; i += nt) {
      buf[side * s.rows * kStride + (real + i / kTile) * kStride + (i & (kTile - 1))] = 0.0;
    }
  }
  double* sW = buf + 2 * s.rows * kStride;
  const int nw = qn * s.k * s.k;
  const double* gW = W + (e * s.nq + q0) * s.k * s.k;
  for (int i = tid; i < nw; i += nt) cp_async_8(sW + i, gW + i);
  if (WEIGHTED) {
    double* sw = sW + s.qr * s.k * s.k;
    for (int i = tid; i < qn; i += nt) cp_async_8(sw + i, wq + e * s.nq + q0 + i);
  }
}

// Zero the columns past C of every stage's A and B rows, once: the copies
// never write them.
__device__ __forceinline__ void zero_edges(const Wide& s, double* smem, int c0, int d0, int tid) {
  constexpr int nt = kProd;
  if (c0 + kTile <= s.C && d0 + kTile <= s.C) return;
  for (int i = tid; i < kStages * 2 * s.rows * kTile; i += nt) {
    const int x = i & (kTile - 1);
    const int row = i / kTile;  // (stage, side, r)
    const int side = (row / s.rows) & 1;
    if ((side == 0 ? c0 : d0) + x >= s.C) {
      smem[(row / (2 * s.rows)) * s.stage + (row % (2 * s.rows)) * kStride + x] = 0.0;
    }
  }
}

// T[q, j, x] = sum_l W[q, j, l] P[q, l, d0 + x] for the round's qn points
// into sT (pad rows zero), on the tensor cores too: per point and half of
// the tile's columns a warp runs mma.sync m8n8k4 with A = W[q] (j < k rows,
// zero-padded to 8; W = F2 * w rounded once as the fragment is loaded) and
// B = P[q, l, half] (l < k, zero-padded to the depth).
template <int KT, bool WEIGHTED>
__device__ __forceinline__ void form_t(const Wide& s, const double* sB, const double* sW,
                                       double* sT, int qn, int tid) {
  constexpr int nt = kProd;
  const int k = KT ? KT : s.k;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const double* sw = sW + s.qr * k * k;
  const int mbs = (k + 7) / 8, slices = (k + 3) / 4;  // 8-row blocks of W, depth steps
  for (int u = tid >> 5; u < 2 * qn; u += nt / 32) {
    const int ql = u >> 1;
    const int x0 = (u & 1) * (kTile / 2);
    const double* wm = sW + ql * k * k;
    const double* pb = sB + ql * k * kStride + x0 + g;
    double* tb = sT + ql * k * kStride + x0 + 2 * t;
    const double wgt = WEIGHTED ? sw[ql] : 0.0;
    for (int mb = 0; mb < mbs; ++mb) {
      const int j = 8 * mb + g;
      double acc[4][2] = {};
#pragma unroll
      for (int sd = 0; sd < slices; ++sd) {
        const int l = 4 * sd + t;
        double a = 0.0;
        if (j < k && l < k) {
          a = wm[j * s.wj + l * s.wl];
          if (WEIGHTED) a = mul_rn(a, wgt);
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const double b = l < k ? pb[l * kStride + 8 * nb] : 0.0;
          dmma_8x8x4(acc[nb][0], acc[nb][1], a, b);
        }
      }
      if (j < k) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          *reinterpret_cast<double2*>(tb + j * kStride + 8 * nb) = make_double2(acc[nb][0], acc[nb][1]);
        }
      }
    }
  }
  for (int i = tid; i < (s.rows - qn * k) * kTile; i += nt) {
    sT[(qn * k + i / kTile) * kStride + (i & (kTile - 1))] = 0.0;
  }
}

// KT: k at compile time (0: at run time).
template <int KT, bool WEIGHTED>
__global__ void __launch_bounds__(kThreadsAll, 2)
    he_assemble_wide_dmma_kernel(const double* __restrict__ P, const double* __restrict__ W,
                        const double* __restrict__ wq, double* __restrict__ He, const Wide s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* const smem = reinterpret_cast<double*>(smem_raw);
  double* const sT0 = smem + kStages * s.stage;
  const int per_elem = s.tiles * s.tiles;
  const int64_t e = blockIdx.x / per_elem;
  const int tile = static_cast<int>(blockIdx.x - e * per_elem);
  const int c0 = (tile / s.tiles) * kTile;
  const int d0 = (tile % s.tiles) * kTile;
  const bool vec = s.C % 2 == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int k = KT ? KT : s.k;

  double acc[4][4][2];  // D[wm + 8 i + g][wn + 8 n + 2 t + {0, 1}] at acc[i][n]
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) acc[mb][nb][0] = acc[mb][nb][1] = 0.0;
  }

  const int nrounds = (s.nq + s.qr - 1) / s.qr;
  auto points = [&](int r) { return s.nq - r * s.qr < s.qr ? s.nq - r * s.qr : s.qr; };

  // The producer warps stage round p + 1 and form T of round p while the
  // MMA warps multiply round p - 1.  Named barrier 1 + (r & 1): T of round r
  // is formed (producers arrive, MMA warps wait); 3 + (r & 1): round r is
  // multiplied (MMA warps arrive; producers wait before reusing its stage
  // and T buffer); 5: the producers alone.
  if (threadIdx.x >= kMmaThreads) {
    const int tid = threadIdx.x - kMmaThreads;
    auto stage = [&](int r) {  // round r into stage r % kStages, one commit group
      if (r < nrounds) {
        stage_round<WEIGHTED>(s, smem + (r % kStages) * s.stage, P, W, wq, e, r * s.qr,
                              points(r), c0, d0, vec, tid);
      }
      cp_async_commit();
    };
    zero_edges(s, smem, c0, d0, tid);
    stage(0);
    for (int p = 0; p < nrounds; ++p) {
      if (p >= 2) bar_sync(3 + (p & 1), kThreadsAll);  // round p - 2 is multiplied
      stage(p + 1);                                     // into the stage of round p - 2
      cp_async_wait<1>();
      bar_sync(5, kProd);  // round p has landed
      const double* sA = smem + (p % kStages) * s.stage;
      form_t<KT, WEIGHTED>(s, c0 == d0 ? sA : sA + s.rows * kStride, sA + 2 * s.rows * kStride,
                           sT0 + (p & 1) * s.rows * kStride, points(p), tid);
      bar_arrive(1 + (p & 1), kThreadsAll);
    }
    return;
  }
  for (int r = 0; r < nrounds; ++r) {
    bar_sync(1 + (r & 1), kThreadsAll);
    // He[c, d] += P[q, j, c] T[q, j, d] over the round, 4 rows a step:
    // 4 A and 4 B fragment loads feed 8 DMMA
    const double* pa = smem + (r % kStages) * s.stage + t * kStride + wm + g;
    const double* pt = sT0 + (r & 1) * s.rows * kStride + t * kStride + wn + g;
    const int steps = (points(r) * k + kDepth - 1) / kDepth;
#pragma unroll 2
    for (int st = 0; st < steps; ++st) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = pa[st * kDepth * kStride + 8 * i];
        b[i] = pt[st * kDepth * kStride + 8 * i];
      }
#pragma unroll
      for (int mp = 0; mp < 2; ++mp) {
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          dmma_16x8x4(acc[2 * mp][nb][0], acc[2 * mp][nb][1], acc[2 * mp + 1][nb][0],
                      acc[2 * mp + 1][nb][1], a[2 * mp], a[2 * mp + 1], b[nb]);
        }
      }
    }
    if (r + 2 < nrounds) bar_arrive(3 + (r & 1), kThreadsAll);
  }

  double* out = He + e * s.C * s.C;
  const bool vec_out = s.C % 2 == 0 && (reinterpret_cast<uintptr_t>(He) & 15) == 0;
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
    const int c = c0 + wm + 8 * mb + g;
    if (c >= s.C) continue;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int d = d0 + wn + 8 * nb + 2 * t;
      double* o = out + static_cast<int64_t>(c) * s.C + d;
      if (vec_out && d < s.C) {
        *reinterpret_cast<double2*>(o) = make_double2(acc[mb][nb][0], acc[mb][nb][1]);
      } else {
        if (d < s.C) o[0] = acc[mb][nb][0];
        if (d + 1 < s.C) o[1] = acc[mb][nb][1];
      }
    }
  }
}

int round_up(int x, int to) { return (x + to - 1) / to * to; }

// Quadrature points per round: the round (qr*k rows, rounded up to the MMA
// depth) holds at most kRowCap rows unless one point exceeds them; among
// those, the least padding, then the most points.
bool make_wide(int nq, int k, int C, bool weighted, bool transposed, Wide* out) {
  if (nq <= 0 || k <= 0 || C <= 0) return false;
  Wide s;
  s.nq = nq, s.k = k, s.C = C;
  s.tiles = (C + kTile - 1) / kTile;
  s.qr = 1;
  double best = 0.0;
  for (int qr = 1; qr <= nq && (qr == 1 || round_up(qr * k, kDepth) <= kRowCap); ++qr) {
    const double fill = static_cast<double>(qr * k) / round_up(qr * k, kDepth);
    if (fill >= best) best = fill, s.qr = qr;
  }
  s.rows = round_up(s.qr * k, kDepth);
  s.wj = transposed ? 1 : k;
  s.wl = transposed ? k : 1;
  s.stage = round_up(2 * s.rows * kStride + s.qr * k * k + (weighted ? s.qr : 0), 2);
  if (static_cast<int64_t>(smem_values(s)) * 8 > kSmemMax) return false;
  *out = s;
  return true;
}

template <int KT, bool WEIGHTED>
int launch_dmma_as(const Wide& s, unsigned blocks, const void* P, const void* W, const void* wq,
                   void* He, void* stream) {
  auto kernel = he_assemble_wide_dmma_kernel<KT, WEIGHTED>;
  const size_t smem = static_cast<size_t>(smem_values(s)) * sizeof(double);
  static size_t opted[64] = {0};  // per device: the dynamic size opted in
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024 && (dev < 0 || dev >= 64 || opted[dev] < smem)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < 64) opted[dev] = smem;
  }
  kernel<<<blocks, kThreadsAll, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(P), static_cast<const double*>(W),
      static_cast<const double*>(wq), static_cast<double*>(He), s);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: SIMT tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 4;        // edge of a thread's register tile
constexpr int kRows = 40;      // rows (q, j) of the reduction axis per round

static_assert(kTile == 16 * kSub && kThreads == 16 * 16, "thread tiling");

// Two consecutive values from shared memory, p on a 2-value boundary.
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

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int64_t grid_of(int64_t nelem, int C) {
  const int64_t tiles = (static_cast<int64_t>(C) + kTile - 1) / kTile;
  return nelem * tiles * tiles;
}

template <bool WEIGHTED>
int launch_f64(const void* P, const void* W, const void* wq, void* He,
               int64_t nelem, int nq, int k, int C, bool transposed, void* stream) {
  if (nelem <= 0) return 0;
  Wide s;
  const int64_t blocks = grid_of(nelem, C);
  if (!make_wide(nq, k, C, WEIGHTED, transposed, &s) || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  switch (k) {
    case 4: return launch_dmma_as<4, WEIGHTED>(s, nb, P, W, wq, He, stream);
    case 5: return launch_dmma_as<5, WEIGHTED>(s, nb, P, W, wq, He, stream);
    case 6: return launch_dmma_as<6, WEIGHTED>(s, nb, P, W, wq, He, stream);
    case 7: return launch_dmma_as<7, WEIGHTED>(s, nb, P, W, wq, He, stream);
    default: return launch_dmma_as<0, WEIGHTED>(s, nb, P, W, wq, He, stream);
  }
}

template <bool WEIGHTED>
int launch_f32(const void* P, const void* W, const void* wq, void* He,
               int64_t nelem, int nq, int k, int C, bool transposed, void* stream) {
  using T = float;
  if (nelem <= 0) return 0;
  if (nq <= 0 || k <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = grid_of(nelem, C);
  if (blocks > INT32_MAX || static_cast<int64_t>(nq) * k * C > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wj = transposed ? 1 : k;
  const int wl = transposed ? k : 1;
  const unsigned nb = static_cast<unsigned>(blocks);
  const int nt = (C + kTile - 1) / kTile;
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
  return launch_f64<false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

extern "C" int mgb_he_assemble_wide_f32(const void* P, const void* W, void* He,
                                        int64_t nelem, int nq, int k, int C,
                                        void* stream) {
  return launch_f32<false>(P, W, nullptr, He, nelem, nq, k, C, false, stream);
}

// F2 (nelem*nq, k, k) with its (j, l) block stored (j, l) (transposed = 0) or
// (l, j) (transposed = 1); w (nelem*nq,).
extern "C" int mgb_he_assemble_wide_weighted_f64(const void* P, const void* F2,
                                                 const void* w, void* He,
                                                 int64_t nelem, int nq, int k,
                                                 int C, int transposed,
                                                 void* stream) {
  return launch_f64<true>(P, F2, w, He, nelem, nq, k, C, transposed != 0, stream);
}

extern "C" int mgb_he_assemble_wide_weighted_f32(const void* P, const void* F2,
                                                 const void* w, void* He,
                                                 int64_t nelem, int nq, int k,
                                                 int C, int transposed,
                                                 void* stream) {
  return launch_f32<true>(P, F2, w, He, nelem, nq, k, C, transposed != 0, stream);
}

// The launch configuration of the weighted entry for a shape: out = {tile
// edge, threads per CTA, CTAs, shared memory in bytes per CTA, rows per
// round, quadrature points per round (0: the round cuts across points), MMA
// m, n, k (0 0 0: no tensor cores)}.  Returns 0, or cudaErrorInvalidValue
// where the kernel does not take the shape.
extern "C" int mgb_he_assemble_wide_config(int elem_size, int64_t nelem, int nq, int k, int C,
                                           int64_t* out) {
  const int64_t ctas = grid_of(nelem, C);
  if (elem_size != 8) {
    if (nq <= 0 || k <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t f32[9] = {kTile, kThreads, ctas, 2 * kRows * kTile * 4, kRows, 0, 0, 0, 0};
    for (int i = 0; i < 9; ++i) out[i] = f32[i];
    return 0;
  }
  Wide s;
  if (!make_wide(nq, k, C, true, false, &s)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t f64[9] = {kTile, kThreadsAll, ctas, static_cast<int64_t>(smem_values(s)) * 8,
                          s.rows, s.qr, 16, 8, kDepth};
  for (int i = 0; i < 9; ++i) out[i] = f64[i];
  return 0;
}
