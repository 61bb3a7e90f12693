// Shared device code of the affine kernels in tensor-product form (sm_90a).
//
// On an affine element the weak Laplacian is sum_c a_c(e) K_c u with
//
//   K0 = Dr^T W Dr,   K1 = Dr^T W Ds + Ds^T W Dr,   K2 = Ds^T W Ds,
//
// so sum_c a_c K_c u = Dr^T fr + Ds^T fs with [ur; us] = [Dr; Ds] u,
// fr = W (a0 ur + a1 us) and fs = W (a1 ur + a2 us): the general kernels'
// flux (sem_general.cuh) with g_c = a_c(e) W, three scalars per element
// instead of (3, n) factor slabs.  With lex node (a, b) of the M x M grid,
// Dr = D (x) I and Ds = I (x) D for the 1D GLL derivative D, so
//
//   ur[a, b] = sum_m D[a, m] u[m, b],   us[a, b] = sum_c D[b, c] u[a, c],
//   S[m, c]  = sum_a D[a, m] fr[a, c] + sum_b D[b, c] fs[m, b]:
//
// 8 N M + 6 N flops per element (6,318 at p = 8) against the 6 N^2
// (39,366) of the assembled blocks K_c.
//
// Layout: a block takes a tile of kAffTile = 32 elements, one per lane, and
// M warps; warp w owns grid line w of every element of the tile: the column
// line (., w), on which it forms ur and the first sum of S, and the row line
// (w, .), on which it forms us and the second sum.  A thread keeps its
// lines (M values each) in registers and every value it stages in shared
// memory feeds M FMAs.  The three hand-overs between column and row lines
// (u, the gradients, the column sums) go through shared memory, 3 N x 32
// floats (31 KB at p = 8), one 128-byte row segment per warp access, free of
// bank conflicts.
//
// Coefficients: D, W and the lex-to-row map come by value in AffineTables,
// a kernel parameter (732 B), which lives in the constant bank.  D's
// indices are compile-time constants once the loops unroll, so each FMA
// takes its coefficient straight from the constant bank; the indices of W
// and of the map depend on the warp only, so a warp reads one word at a
// time (a broadcast).
//
// Node orders: L-vector rows are in the exchange's order (edges first), row
// j holding lex node hier[j]; AffineTables.row is its inverse (lex node ->
// row), so a warp reads the rows of its column line and writes the rows of
// its row line directly, each as one 128-byte segment of an (n, E) array.
//
// Users: the apply (affine_apply_dss.cu), kernel A (cg_kernel_a.cu) and the
// single-kernel iteration (cg_kernel_single.cu).  Each forms the product's
// operand on the column line and takes S on the row line from this one
// function, so their Ap' equals the apply of their stored p' bit for bit.
#pragma once

#include "sem_general.cuh"

namespace sem {

constexpr int kAffTile = 32;     // elements per block, one per lane
constexpr int kAffMaxN = 81;     // the largest compiled n (p = 8)

// The by-value operand of the affine kernels (built on the host by
// ops/kernels.py AffineFactors).  For n = M^2 only the first M^2 entries of
// each array count.
struct AffineTables {
  float D[kAffMaxN];             // D[a * M + m]: the 1D derivative, lex
  float W[kAffMaxN];             // W[a * M + b]: the quadrature weights
  unsigned char row[kAffMaxN];   // lex node -> L-vector row
};

template <int N>
struct AffSmem {
  static constexpr int M = grid_side(N);
  float u[N][kAffTile];   // the tile's u (lex), then the column sums of S
  float r[N][kAffTile];   // ur (lex)
  float s[N][kAffTile];   // us (lex)
};

template <int N>
__host__ __device__ constexpr int aff_threads() {
  return 32 * grid_side(N);
}

// aff_product's hook when the caller stages nothing.
struct AffNoHook {
  template <typename Smem>
  __device__ __forceinline__ void operator()(Smem&) const {}
};

// The local product S = sum_c a_c K_c u of this lane's element, in
// tensor-product form.  x: u on the column line (., w) of this thread's
// warp w (zeros, and zero scales, for a lane past the last element).  On
// return S[c] holds lex node (w, c), the row line, and y[c] the u of that
// node (read from the column lines' hand-over).  Three barriers: every
// thread of the block calls it.
//
// hook(sm) runs between the second and the third barrier, after this
// thread's last read of sm.r and sm.s: the slots sm.s[a M + w] (column
// line) and sm.r[w M + a] (row line) are then read by no other thread, so
// the hook may write its own values for column-line node (a, w) there,
// which the row-line owner of that node (warp a) reads after the return
// (see cg_kernel_single.cu).  The product itself does not depend on it.
template <int N, typename Hook = AffNoHook>
__device__ __forceinline__ void aff_product(
    AffSmem<N>& sm, const AffineTables& t, const float (&x)[AffSmem<N>::M],
    float a0, float a1, float a2, float (&S)[AffSmem<N>::M],
    float (&y)[AffSmem<N>::M], const Hook& hook = Hook()) {
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
        gr = fmaf(t.D[a * M + m], x[m], gr);
        gs = fmaf(t.D[a * M + m], y[m], gs);
      }
      ur[a] = gr;
      us[a] = gs;
    }
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    sm.r[a * M + w][lane] = ur[a];
    sm.s[w * M + a][lane] = us[a];
  }
  __syncthreads();
  // the flux: fr on the column line, fs on the row line, each taking the
  // other gradient from the line that formed it
  float fr[M], fs[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    fr[a] = t.W[a * M + w] * fmaf(a0, ur[a], a1 * sm.s[a * M + w][lane]);
    fs[a] = t.W[w * M + a] * fmaf(a1, sm.r[w * M + a][lane], a2 * us[a]);
  }
  hook(sm);
  // sum_a D[a, m] fr[a, w] at (m, w) into sm.u (read last before the
  // second barrier); sum_b D[b, c] fs[w, b] at (w, c) into S
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float sc = 0.f, sr = 0.f;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      sc = fmaf(t.D[a * M + m], fr[a], sc);
      sr = fmaf(t.D[a * M + m], fs[a], sr);
    }
    sm.u[m * M + w][lane] = sc;
    S[m] = sr;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < M; ++c) S[c] += sm.u[w * M + c][lane];
}

}  // namespace sem
