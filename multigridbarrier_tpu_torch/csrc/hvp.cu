// Fused matrix-free H v: gather, element matvec and node sum in one launch
//
//   out[f, a] = sum_w dot(tbl[a, w], f)                   for a < m,  out[f, m] = 0
//   dot(j, f) = sum_b He[e, f*nl + slot, b] * vp[b / nl, idx[e, b % nl]]
//               with (e, slot) = (j / nl, j % nl)
//
// Replaces tools/probe_pallas_gather.py:pallas_hvp (kernel body k_hvp), which
// is multigridbarrier_tpu/solver/linsolve.py:hvp in kernel form: one fused
// kernel there, one launch here.  It computes what kernel B
// (element_matvec.cu) followed by kernel C (table_sum.cu) compute, without
// the (nelem*nl, nf) intermediate and without atomics: every matvec row
// belongs to exactly one node, so the lanes that own output (f, a) walk the
// table row of a and form each entry's row product themselves.
//
// What bounds it on an H100: each He row (C values: 96 bytes at C = 12 in
// float64, three aligned 32-byte sectors) is read once, with nl indices and
// C gathered coefficients from L2 and one add per row — 0.25 flop per byte,
// so bytes; at fem2d sizes (8192 elements, 16k nodes) latency and the launch.
//
// Design: as in table_sum.cu, a group of G lanes of one warp owns an output
// (G the power of two that covers the table width, at most 32; the coarsest
// fem2d levels have rows of thousands of entries).  Lane g takes entry
// w0 + g of the row: it loads the element's indices, gathers the
// coefficients and sums the C products with b ascending from zero in the
// `acc += a * b` form of kernel B, so all entries of a round are in flight
// together; on rows wider than a warp a lane takes four entries a round,
// G apart, and advances their four sums together.  At nl = 6 the sums are
// unrolled and indices and He values come in pairs.  Then every lane of the
// group adds the round's row products in table order from zero (warp
// shuffles), kernel C's order.  The result equals
// table_sum(element_matvec(...)) bit for bit; a sentinel entry adds +0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

constexpr int kWide = 4;  // entries per lane and round on rows wider than a warp

template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using type = double2;
};
template <>
struct Pair<float> {
  using type = float2;
};

// U entries per lane and round: the group's round covers U*G consecutive
// table entries, entry w0 + u*G + g by lane g.  NL: nl at compile time (even;
// 0: at run time), which unrolls the sum over a field's nl slots and loads
// indices and He values in pairs.
template <typename T, int U, int NL>
__global__ void __launch_bounds__(kThreads)
    hvp_kernel(const T* __restrict__ He, const int32_t* __restrict__ idx,
               const int32_t* __restrict__ tbl, const T* __restrict__ vp,
               T* __restrict__ out, int rows, int64_t m, int width, int nl_rt,
               int nf, int shift) {
  using T2 = typename Pair<T>::type;
  const int nl = NL ? NL : nl_rt;
  const int G = 1 << shift;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int first = lane - g;  // the group's first lane
  const int64_t o =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> shift;
  const int64_t mp1 = m + 1;
  const bool live = o < mp1 * nf;
  const int f = live ? static_cast<int>(o / mp1) : 0;
  const int64_t a = live ? o - f * mp1 : 0;
  const bool real = live && a < m;
  const int C = nf * nl;
  const int32_t* row = tbl + a * width;
  // The row products of this lane's U entries of the round at w0.  The U
  // sums advance together and nothing branches, so their loads are in
  // flight together: a lane without an entry (past the row's end, a
  // sentinel, the pad row) sums entry 0 and drops the result.
  auto dots = [&](int w0, T(&dot)[U]) {
    const T* h[U];
    const int32_t* ie[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = w0 + u * G + g;
      ok[u] = real && w < width;
      int j = ok[u] ? __ldg(row + w) : 0;
      ok[u] = ok[u] && j >= 0 && j < rows;
      if (!ok[u]) j = 0;
      const int e = j / nl;
      h[u] = He + (static_cast<int64_t>(e) * C + f * nl + (j - e * nl)) * C;
      ie[u] = idx + static_cast<int64_t>(e) * nl;
      dot[u] = T(0);
    }
    if constexpr (NL != 0) {
      int node[U][NL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int ab = 0; ab < NL; ab += 2) {
          const int2 p = __ldg(reinterpret_cast<const int2*>(ie[u] + ab));
          node[u][ab] = p.x;
          node[u][ab + 1] = p.y;
        }
      }
      for (int fb = 0; fb < nf; ++fb) {
        const T* v = vp + fb * mp1;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          T hv[NL], vv[NL];
#pragma unroll
          for (int ab = 0; ab < NL; ab += 2) {
            const T2 p = __ldg(reinterpret_cast<const T2*>(h[u] + fb * NL + ab));
            hv[ab] = p.x;
            hv[ab + 1] = p.y;
          }
#pragma unroll
          for (int ab = 0; ab < NL; ++ab) vv[ab] = __ldg(v + node[u][ab]);
#pragma unroll
          for (int ab = 0; ab < NL; ++ab) dot[u] += hv[ab] * vv[ab];
        }
      }
    } else {
      for (int fb = 0; fb < nf; ++fb) {
        const T* v = vp + fb * mp1;
        for (int ab = 0; ab < nl; ++ab) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            dot[u] += __ldg(h[u] + fb * nl + ab) * __ldg(v + __ldg(ie[u] + ab));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) dot[u] = ok[u] ? dot[u] : T(0);
  };
  T acc = T(0);
  T cur[U];
  for (int w0 = 0; w0 < width; w0 += U * G) {
    dots(w0, cur);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int l = 0; l < G; ++l) acc += __shfl_sync(0xffffffffu, cur[u], first + l);
    }
  }
  if (live && g == 0) out[o] = acc;
}

template <typename T>
int launch(const void* He, const int32_t* idx, const int32_t* tbl,
           const void* vp, void* out, int64_t rows, int64_t m, int width,
           int nl, int nf, void* stream) {
  const int64_t total = (m + 1) * nf;
  if (total <= 0) return 0;
  if (rows < 0 || rows > INT32_MAX || nl <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int shift = 0;
  while ((1 << shift) < width && shift < 5) ++shift;
  const int64_t per_block = kThreads >> shift;
  const int64_t blocks = (total + per_block - 1) / per_block;
  // nl = 6 (fem2d's quadratic triangles) is unrolled; its paired loads need
  // He and idx on 16- and 8-byte boundaries, which PyTorch's allocations are
  const bool six = nl == 6 && (reinterpret_cast<uintptr_t>(He) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 7) == 0;
  const bool wide = width > 32;
  auto kernel = six ? (wide ? hvp_kernel<T, kWide, 6> : hvp_kernel<T, 1, 6>)
                    : (wide ? hvp_kernel<T, kWide, 0> : hvp_kernel<T, 1, 0>);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(He), idx, tbl, static_cast<const T*>(vp),
      static_cast<T*>(out), static_cast<int>(rows), m, width, nl, nf, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// He (rows / nl, nf*nl, nf*nl), idx (rows / nl, nl) with entries in [0, m],
// tbl (m+1, width), vp (nf, m+1) -> out (nf, m+1).
extern "C" int mgb_hvp_f64(const void* He, const int32_t* idx,
                           const int32_t* tbl, const void* vp, void* out,
                           int64_t rows, int64_t m, int width, int nl, int nf,
                           void* stream) {
  return launch<double>(He, idx, tbl, vp, out, rows, m, width, nl, nf, stream);
}

extern "C" int mgb_hvp_f32(const void* He, const int32_t* idx,
                           const int32_t* tbl, const void* vp, void* out,
                           int64_t rows, int64_t m, int width, int nl, int nf,
                           void* stream) {
  return launch<float>(He, idx, tbl, vp, out, rows, m, width, nl, nf, stream);
}
