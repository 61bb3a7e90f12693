// Shared device code of the general (curved-mesh) kernels: the element-local
// weak Laplacian with full geometric-factor slabs,
//
//   [ur; us] = Dhat u,   flux = [g0 ur + g1 us; g1 ur + g2 us],
//   S = Dhat^T flux,
//
// in tensor-product form: with lex node (a, b) of an M x M grid (N = M^2),
// Dhat = [D0 (x) I; I (x) D1], so
//
//   ur[a, b] = sum_m D0[a, m] u[m, b],   us[a, b] = sum_c D1[b, c] u[a, c],
//   S[m, c]  = sum_a D0[a, m] fr[a, c] + sum_b D1[b, c] fs[m, b].
//
// That is 8 N M + 6 N flops per element (6,318 at p = 8) instead of the
// 8 N^2 of the dense stacked derivative.
//
// Node orders: the L-vector rows are in the exchange's hierarchical order
// (edges first), row j holding lex node hier[j]; the factor slabs gT (3, N, E)
// and the derivative's tensor factors are in lex order.  A block reads row j
// of u into lex slot hier[j] of shared memory, forms the gradients and the
// flux in lex order, and computes row j of S from lex node hier[j], so S
// comes out in hier order.  D0 and D1 are read from the hier-permuted dense
// Dhat_h = Dhat[:, hier] the plain version uses: D0[a, m] = Dhat[a M, m M],
// D1[b, c] = Dhat[N + b, c], each column through the inverse of hier.
//
// Layout: a block takes a tile of kGenTile = 32 elements, one per lane, and
// its 8 warps split the nodes (warp w takes rows w, w + 8, ...), so every
// global load and store is one 128-byte row segment of a (rows, E) array.
// The tile's values and its flux sit in shared memory (3 N x 32 floats,
// 31 KB at p = 8); the tensor factors D0 and D1 are read as broadcasts.
// The row pitch P of those arrays is 32 floats for the kernels above; a
// kernel that stages its tile element by element (laplacian_local.cu) pads
// it to 33, so that a warp's stores to one column fall in distinct banks.
// gen_flux_by reads the factors through an accessor g(c, q) (factor c of lex
// node q of this lane's element), so a kernel may keep them in global
// memory (SlabFactors, the (3, N, E) slabs) or stage them.
#pragma once

#include "sem_kernels.cuh"

namespace sem {

constexpr int kGenTile = 32;                       // elements per block
constexpr int kGenThreads = 256;                   // 8 warps
constexpr int kGenWarps = kGenThreads / 32;

__host__ __device__ constexpr int grid_side(int n) {
  int m = 0;
  while ((m + 1) * (m + 1) <= n) ++m;
  return m;
}

template <int N, int P = kGenTile>
struct GenSmem {
  static constexpr int M = grid_side(N);
  float u[N][P];               // the tile's input, lex order
  float f[2 * N][P];           // the flux [fr; fs], lex order
  float D0[M][M], D1[M][M];
  int hier[N];                 // L-vector row -> lex node
  int hinv[N];                 // lex node -> L-vector row
};

// hier and the tensor factors into shared memory (ends with a barrier).
template <int N, int P>
__device__ __forceinline__ void gen_load_tables(GenSmem<N, P>& s,
                                                const float* __restrict__ Dh,
                                                const int* __restrict__ hier) {
  constexpr int M = GenSmem<N, P>::M;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const int q = hier[j];
    s.hier[j] = q;
    s.hinv[q] = j;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < M * M; t += blockDim.x) {
    const int i = t / M, c = t % M;
    // D0[i][c] = Dhat[i M, c M];  D1[i][c] = Dhat[N + i, c]
    s.D0[i][c] = Dh[(size_t)(i * M) * N + s.hinv[c * M]];
    s.D1[i][c] = Dh[(size_t)(N + i) * N + s.hinv[c]];
  }
  __syncthreads();
}

// The factors of element e as (3, N, E) slabs in global memory.
template <int N>
struct SlabFactors {
  const float* __restrict__ gT;
  int E, e;
  __device__ __forceinline__ float operator()(int c, int q) const {
    return gT[(size_t)(c * N + q) * E + e];
  }
};

// Gradients and flux of the tile in s.u, into s.f.  g(c, q): factor c of
// lex node q of this lane's element, read only when valid (the other lanes
// get a zero flux).  Each thread reads g(., q) for its own (q, lane) before
// it writes s.f[q][lane] and s.f[N + q][lane], so an accessor may read
// factors staged in those very slots.
template <int N, int P, class G>
__device__ __forceinline__ void gen_flux_by(GenSmem<N, P>& s, const G& g,
                                            bool valid) {
  constexpr int M = GenSmem<N, P>::M;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int q = w; q < N; q += kGenWarps) {
    const int a = q / M, b = q % M;
    float ur = 0.f, us = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) ur = fmaf(s.D0[a][m], s.u[m * M + b][lane], ur);
#pragma unroll
    for (int c = 0; c < M; ++c) us = fmaf(s.D1[b][c], s.u[a * M + c][lane], us);
    float g0 = 0.f, g1 = 0.f, g2 = 0.f;
    if (valid) {
      g0 = g(0, q);
      g1 = g(1, q);
      g2 = g(2, q);
    }
    s.f[q][lane] = fmaf(g0, ur, g1 * us);
    s.f[N + q][lane] = fmaf(g1, ur, g2 * us);
  }
}

// gen_flux_by with the factors read from the (3, N, E) slabs gT; e is this
// lane's element (valid when e < E).
template <int N>
__device__ __forceinline__ void gen_flux(GenSmem<N>& s,
                                         const float* __restrict__ gT, int E,
                                         int e, bool valid) {
  gen_flux_by(s, SlabFactors<N>{gT, E, e}, valid);
}

// Row j (hier order) of S = Dhat^T flux for this lane's element.
template <int N, int P>
__device__ __forceinline__ float gen_row(const GenSmem<N, P>& s, int j,
                                         int lane) {
  constexpr int M = GenSmem<N, P>::M;
  const int q = s.hier[j];
  const int m = q / M, c = q % M;
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < M; ++a) acc = fmaf(s.D0[a][m], s.f[a * M + c][lane], acc);
#pragma unroll
  for (int b = 0; b < M; ++b)
    acc = fmaf(s.D1[b][c], s.f[N + m * M + b][lane], acc);
  return acc;
}

}  // namespace sem
