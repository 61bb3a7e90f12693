// general_apply_dss: out = DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us]) with
// [ur; us] = Dhat u, on transposed (n, E) f32 L-vectors of a curved
// (non-affine) mesh, or on a (k * n, E) stack of k that share the operator
// (the factor slabs, Dhat, the class tables).
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
// Design (see sem_general.cuh): general_local_kernel takes a tile of 32
// elements per block, the tile's u and flux in shared memory, the two
// derivative products in tensor-product form (no library product), and
// writes the element-interior rows [nb, n) of S straight to out and the
// exchanged rows [0, nb) to the scratch B; dss_gather_kernel then sums the
// roll classes into out[0, nb).  The RHS of a stack is the fastest index of
// the grid (block b: tile b / k, RHS b % k), so the k blocks of one tile run
// together and read its factor slabs through L2 once.  No TPU mechanism is
// carried over: no lane windows or halo triples, no far split, no bf16x3
// split (the FMAs are true f32).
#include "sem_general.cuh"

namespace sem {

template <int N>
__global__ void __launch_bounds__(kGenThreads)
    general_local_kernel(const float* __restrict__ u,
                         const float* __restrict__ gT,
                         const float* __restrict__ Dh,
                         const int* __restrict__ hier,
                         float* __restrict__ out, float* __restrict__ B,
                         int E, int nb, int k) {
  __shared__ GenSmem<N> s;
  gen_load_tables<N>(s, Dh, hier);
  const int tile = blockIdx.x / k, rhs = blockIdx.x % k;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = tile * kGenTile + lane;
  const bool valid = e < E;
  u += (size_t)rhs * N * E;
  out += (size_t)rhs * N * E;
  B += (size_t)rhs * nb * E;
  for (int j = w; j < N; j += kGenWarps)
    s.u[s.hier[j]][lane] = valid ? u[(size_t)j * E + e] : 0.f;
  __syncthreads();
  gen_flux<N>(s, gT, E, e, valid);
  __syncthreads();
  if (!valid) return;
  for (int j = w; j < N; j += kGenWarps) {
    const float v = gen_row<N>(s, j, lane);
    if (j < nb)
      B[(size_t)j * E + e] = v;
    else
      out[(size_t)j * E + e] = v;
  }
}

template <int N>
cudaError_t launch_general_local(const float* u, const float* gT,
                                 const float* Dh, const int* hier, float* out,
                                 float* B, int E, int nb, int k,
                                 cudaStream_t stream) {
  const int tiles = (E + kGenTile - 1) / kGenTile;
  general_local_kernel<N><<<tiles * k, kGenThreads, 0, stream>>>(
      u, gT, Dh, hier, out, B, E, nb, k);
  return cudaGetLastError();
}

}  // namespace sem

// u, out: (k * n, E) f32; gT: (3, n, E) f32 lex-order factor slabs; Dh:
// (2n, n) f32 stacked derivative with columns in hier order; hier: (n,)
// int32; B: (k, nb, E) f32 scratch; row_ptr: (nb + 1,) int32; entries:
// (T, 4) int32; masks: (C, E) bool.  Returns a cudaError_t code (0 on
// success).
extern "C" int sem_general_apply_dss(const void* u, const void* gT,
                                     const void* Dh, const void* hier,
                                     void* out, void* B, const void* row_ptr,
                                     const void* entries, const void* masks,
                                     int n, int E, int nb, int k,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(gT);
  const float* df = static_cast<const float*>(Dh);
  const int* hi = static_cast<const int*>(hier);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = sem::launch_general_local<NN>(uf, gf, df, hi, of, Bf, E, nb, k,   \
                                        s);                                 \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
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
