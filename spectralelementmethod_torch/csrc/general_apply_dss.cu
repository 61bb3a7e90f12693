// general_apply_dss: out = DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us]) with
// [ur; us] = Dhat u, on transposed (n, E) f32 L-vectors of a curved
// (non-affine) mesh, or on a (k * n, E) stack of k that share the operator
// (the factor slabs, the tables, the class tables).
//
// Replaces the TPU kernel make_fused_general_laplacian_T
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1179, pallas_call at
// :1299; n_rhs = k for the stack): the operator apply of plain CG on curved
// meshes, of the Dirichlet lift and of the fused solvers' true-residual
// checks.
//
// What bounds it on an H100 (p = 8, n = 81, E = 99,856): it must read u and
// the (3, n, E) factor slabs and write out, 20 B per node or 162 MB, 48 us
// at 3.35 TB/s, against 6.3 kflop per element (0.63 GFLOP, 9 us at
// 67 TFLOP/s): bound by bytes, the slabs three fifths of them.  A k-stack
// reads the slabs once per tile for all k: 8 k + 12 B per node.
//
// Design: two launches.  general_local_kernel runs the curved product of
// sem_curved.cuh: a tile of 32 elements per block and M warps, one per
// grid line, D0, D1 and the node order by value in the constant bank (no
// per-block table setup), each node's factors copied once into shared
// memory by cp.async issued before anything else (52 KB of shared memory
// per block at p = 8).  It writes the element-interior rows [nb, n) of S
// straight to out and the exchanged rows [0, nb) to the scratch B;
// dss_gather_kernel (sem_kernels.cuh) then sums the roll classes into
// out[0, nb), and far_update reads B for the far classes of a split DSS.
// The RHS of a stack is the fastest index of the grid (block b: tile b / k,
// RHS b % k), so the k blocks of one tile run together and read its factor
// slabs (97 MB at p = 8, twice the 50 MB L2) through L2 once; the affine
// kernels put the RHS in blockIdx.y because they read 1.2 MB of scales.
// No TPU mechanism is carried over: no lane windows or halo triples, no far
// split in the kernel, no bf16x3 split (the FMAs are true f32).
#include <cstring>

#include "sem_curved.cuh"

namespace sem {

// resident blocks per SM in the launch bounds (M warps each): 3 (64
// registers) ran 10% faster than 4 (56 registers, the most the shared
// memory allows) on an H100 at p = 8 (scripts/torch_general_variants.py)
constexpr int kGenApplyMinBlocks = 3;

template <int N>
__global__ void __launch_bounds__(aff_threads<N>(), kGenApplyMinBlocks)
    general_local_kernel(const float* __restrict__ u, const GeneralTables t,
                         const float* __restrict__ gT,
                         float* __restrict__ out, float* __restrict__ B,
                         int E, int nb, int k) {
  constexpr int M = AffSmem<N>::M;
  CurvedSmem<N>& cs = *reinterpret_cast<CurvedSmem<N>*>(curved_smem);
  const int tile = blockIdx.x / k, rhs = blockIdx.x % k;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = tile * kAffTile + lane;
  const bool valid = e < E;
  gen_stage_factors<N>(cs, gT, E, e, valid);
  u += (size_t)rhs * N * E;
  out += (size_t)rhs * N * E;
  B += (size_t)rhs * nb * E;
  float x[M], S[M], y[M];
#pragma unroll
  for (int a = 0; a < M; ++a)
    x[a] = valid ? u[(size_t)t.row[a * M + w] * E + e] : 0.f;
  gen_product<N>(cs, t, x, S, y);
  if (!valid) return;
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const int j = t.row[w * M + c];
    if (j < nb)
      B[(size_t)j * E + e] = S[c];
    else
      out[(size_t)j * E + e] = S[c];
  }
}

template <int N>
cudaError_t launch_general_local(const float* u, const GeneralTables& t,
                                 const float* gT, float* out, float* B,
                                 int E, int nb, int k, cudaStream_t stream) {
  const cudaError_t err = curved_smem_attribute<N>(general_local_kernel<N>);
  if (err != cudaSuccess) return err;
  const int tiles = (E + kAffTile - 1) / kAffTile;
  general_local_kernel<N><<<tiles * k, aff_threads<N>(),
                            sizeof(CurvedSmem<N>), stream>>>(u, t, gT, out,
                                                             B, E, nb, k);
  return cudaGetLastError();
}

}  // namespace sem

// The size of GeneralTables, for the host side's check of its layout.
extern "C" int sem_general_tables_size() {
  return static_cast<int>(sizeof(sem::GeneralTables));
}

// u, out: (k * n, E) f32; tables: host pointer to the operator's
// GeneralTables (sem_curved.cuh; copied here, then passed by value); gT:
// (3, n, E) f32 lex-order factor slabs; B: (k, nb, E) f32 scratch;
// row_ptr: (nb + 1,) int32; entries: (T, 4) int32; masks: (C, E) bool.
// Returns a cudaError_t code (0 on success).
extern "C" int sem_general_apply_dss(const void* u, const void* tables,
                                     const void* gT, void* out, void* B,
                                     const void* row_ptr,
                                     const void* entries, const void* masks,
                                     int n, int E, int nb, int k,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sem::GeneralTables t;
  std::memcpy(&t, tables, sizeof t);
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(gT);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = sem::launch_general_local<NN>(uf, t, gf, of, Bf, E, nb, k, s);    \
    break;
    SEM_APPLY_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sem::launch_dss_gather(
      Bf, of, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), n,
      E, nb, k, s));
}
