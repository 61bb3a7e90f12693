// Shared device code of the curved-mesh (general-factor) kernels in
// tensor-product form (sm_90a): the apply (general_apply_dss.cu) and its
// kernel A (cg_kernel_a_general.cu).
//
// On a curved element the weak Laplacian has per-node geometric factors,
//
//   [ur; us] = Dhat u,   S = Dhat^T [g0 ur + g1 us; g1 ur + g2 us],
//
// and Dhat = [D0 (x) I; I (x) D1] on the M x M grid of lex nodes (a, b), so
//
//   ur[a, b] = sum_m D0[a, m] u[m, b],   us[a, b] = sum_c D1[b, c] u[a, c],
//   S[m, c]  = sum_a D0[a, m] fr[a, c] + sum_b D1[b, c] fs[m, b]
//
// with fr = g0 ur + g1 us and fs = g1 ur + g2 us: 8 N M + 6 N flops per
// element (6,318 at p = 8).  This is aff_product (sem_affine.cuh) with the
// node's factors in place of a_c W and a derivative per direction.
//
// Layout: aff_product's tile and hand-overs.  A block takes kAffTile = 32
// elements, one per lane, and M warps; warp w owns the column line (., w)
// of every element of the tile, on which it forms ur, fr and the first sum
// of S, and the row line (w, .), on which it forms us, fs and the second
// sum.  Each value staged in shared memory (3 N x 32 floats, 31 KB at
// p = 8: u, the gradients, the column sums) feeds M FMAs.
//
// Factor reads: each node's three factors are read from device memory once,
// by cp.async into shared memory, issued before anything else: the (3, N, E)
// slabs are three fifths of the apply's bytes and do not depend on u, so
// they are in flight while u is loaded and handed over and the gradients
// are formed, and they hold no register meanwhile.  The column owner of
// node (a, w) stages g0 and g1 there, the row owner of node (w, b) stages
// g2; each thread reads back only what it staged, so its own
// cp.async.wait_all makes them visible.  fs needs g1 ur on the row line:
// the column owner hands over g1 ur in place of ur (the second hand-over),
// so no factor is read twice.  g2 is staged in the slot of the hand-over of
// us, which its row owner writes after it has formed g2 us; g0 and g1 take
// another 2 N x 32 floats: 52 KB of dynamic shared memory per block at
// p = 8, so 4 blocks fit an SM.
//
// Coefficients: D0, D1, their transposes and the lex-to-row map come by
// value in GeneralTables, a kernel parameter (1,380 B) in the constant bank,
// built on the host from Dhat and the node order (ops/kernels.py
// GeneralFactors).  The indices of the derivatives are compile-time
// constants once the loops unroll; the map's depend on the warp only.  The
// gradients read D0 and D1, the sums of S their transposes, so that each
// coefficient is read once: with one table for both phases the compiler kept
// the 2 M^2 coefficients in registers from the first use to the second and
// spilled 220-580 B per thread at p = 8 (at 56 to 96 registers).
//
// Node orders: L-vector rows are in the exchange's order (edges first),
// row j holding lex node hier[j]; GeneralTables.row is its inverse.  The
// factor slabs gT (3, N, E) are in lex order.  Every global access of a
// warp is one 128-byte segment of one row of an (rows, E) array.
//
// Users: the apply and kernel A.  Both form the product's operand on the
// column line and take S on the row line from gen_product, so kernel A's
// Ap' equals the apply of its stored p' bit for bit.
#pragma once

#include "sem_affine.cuh"

namespace sem {

// The by-value operand of the curved kernels.  For n = M^2 only the first
// M^2 entries of each array count.
struct GeneralTables {
  float D0[kAffMaxN];            // D0[a * M + m]: d/dr, lex
  float D1[kAffMaxN];            // D1[b * M + c]: d/ds, lex
  float D0t[kAffMaxN];           // D0t[m * M + a] = D0[a * M + m]
  float D1t[kAffMaxN];           // D1t[c * M + b] = D1[b * M + c]
  unsigned char row[kAffMaxN];   // lex node -> L-vector row
};

// The tile's shared memory: the product's hand-overs and the staged g0
// and g1 (lex order, as the slabs); g2 is staged in h.s.
template <int N>
struct CurvedSmem {
  AffSmem<N> h;
  float g[2][N][kAffTile];
};

// One 4-byte asynchronous copy from device to shared memory; zeros when
// !valid (then nothing is read: src may be any device address).
__device__ __forceinline__ void stage4(float* dst, const float* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Issue the factor copies of this lane's element e (zeros for a lane past
// the last element) from the lex-order (3, N, E) slabs gT: g0 and g1 of the
// column line into sm.g, g2 of the row line into sm.h.s.
template <int N>
__device__ __forceinline__ void gen_stage_factors(CurvedSmem<N>& sm,
                                                  const float* __restrict__ gT,
                                                  int E, int e, bool valid) {
  constexpr int M = AffSmem<N>::M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* src = gT + (valid ? e : 0);
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const int qc = a * M + w, qr = w * M + a;
    stage4(&sm.g[0][qc][lane], src + (size_t)qc * E, valid);
    stage4(&sm.g[1][qc][lane], src + (size_t)(N + qc) * E, valid);
    stage4(&sm.h.s[qr][lane], src + (size_t)(2 * N + qr) * E, valid);
  }
}

// The dynamic shared memory of a kernel on this tile (above the 48 KB of
// static shared memory at p = 8): set once per kernel and device.  Internal
// linkage: a process may load several builds of one source, each with its
// own CUDA runtime, and a static of an external template would be shared by
// all of them (so only the first would set its attribute).
template <int N, typename Kernel>
static cudaError_t curved_smem_attribute(Kernel kernel) {
  static OncePerDevice once;
  return once([kernel] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(CurvedSmem<N>)));
  });
}

extern __shared__ __align__(16) unsigned char curved_smem[];

// The local product S = Dhat^T flux of this lane's element, its factors
// staged by gen_stage_factors.  x: u on the column line (., w) of this
// thread's warp w (zeros, with zero factors, for a lane past the last
// element).  On return S[c] holds lex node (w, c), the row line, and y[c]
// the u of that node (read from the column lines' hand-over).  Three
// barriers: every thread of the block calls it.
template <int N>
__device__ __forceinline__ void gen_product(CurvedSmem<N>& cs,
                                            const GeneralTables& t,
                                            const float (&x)[AffSmem<N>::M],
                                            float (&S)[AffSmem<N>::M],
                                            float (&y)[AffSmem<N>::M]) {
  AffSmem<N>& sm = cs.h;
  constexpr int M = AffSmem<N>::M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < M; ++a) sm.u[a * M + w][lane] = x[a];
  __syncthreads();
  // ur on the column line (a, w), us on the row line (w, a)
  float ur[M], us[M];
  {
#pragma unroll
    for (int c = 0; c < M; ++c) y[c] = sm.u[w * M + c][lane];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      float gr = 0.f, gs = 0.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        gr = fmaf(t.D0[a * M + m], x[m], gr);
        gs = fmaf(t.D1[a * M + m], y[m], gs);
      }
      ur[a] = gr;
      us[a] = gs;
    }
  }
  // this thread's staged factors have landed; the column line hands over
  // g1 ur, the row line forms g2 us and hands over us in g2's slot
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float g2us[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    sm.r[a * M + w][lane] = cs.g[1][a * M + w][lane] * ur[a];
    g2us[a] = __fmul_rn(sm.s[w * M + a][lane], us[a]);
    sm.s[w * M + a][lane] = us[a];
  }
  __syncthreads();
  // the flux: fr on the column line, fs on the row line (g2 us and g1 ur
  // rounded as products: no contraction, which could differ between the
  // kernels that inline this function)
  float fr[M], fs[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    fr[a] = fmaf(cs.g[0][a * M + w][lane], ur[a],
                 cs.g[1][a * M + w][lane] * sm.s[a * M + w][lane]);
    fs[a] = __fadd_rn(g2us[a], sm.r[w * M + a][lane]);
  }
  // sum_a D0[a, m] fr[a, w] at (m, w) into sm.u (read last before the
  // second barrier); sum_b D1[b, c] fs[w, b] at (w, c) into S
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float sc = 0.f, sr = 0.f;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      sc = fmaf(t.D0t[m * M + a], fr[a], sc);
      sr = fmaf(t.D1t[m * M + a], fs[a], sr);
    }
    sm.u[m * M + w][lane] = sc;
    S[m] = sr;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < M; ++c) S[c] += sm.u[w * M + c][lane];
}

}  // namespace sem
