// affine_apply_dss: out = DSS(sum_c a_c K_c u) on transposed (n, E) f32
// L-vectors, for affine meshes, or on a (k * n, E) stack of k of them that
// share the operator (the affine scales, the class tables).
//
// Replaces the TPU kernel make_fused_affine_laplacian_T
// (spectralelementmethod_tpu/ops/pallas_kernels.py:986, pallas_call at
// :1086; n_rhs = k for the stack), the operator apply of every plain-CG
// iteration on the main path (k = 1) and of the batched plain CG.
//
// What bounds it on an H100 (p = 8, n = 81, E = 99,856): bytes.  It must
// read u, the affine scales and the class masks and write out, 67.6 MB,
// 20 us at 3.35 TB/s.  The product in tensor-product form (sem_affine.cuh)
// does 6.3 kflop per element, 0.63 GFLOP, 9 us at the SXM part's
// 67 TFLOP/s on the CUDA cores.  A k-stack does k times both.
//
// Design: two launches.  affine_local_kernel computes the product from
// the 1D derivative D, the weights W and three scales per element (no
// assembled K): a tile of 32 elements per block, one warp per grid line,
// each value staged in shared memory feeding M FMAs and each coefficient
// read from the constant bank (the by-value AffineTables), so neither
// shared-memory issue nor the flops of the assembled form (6.2x these) set
// its pace.  3,121 blocks of 9 warps at E = 99,856, 800 for one shard's
// 25,598; the launch bounds hold it to 56 registers, so 4 blocks (36
// warps) stay resident per SM (on an H100 the global apply took 0.076 ms
// at 72 registers and 3 blocks against 0.068 ms; 5 blocks spill).  It
// writes the element-interior rows [nb, n) of S straight to
// out and the exchanged rows [0, nb) to the scratch B; dss_gather_kernel
// (sem_kernels.cuh) then sums the roll classes into out[0, nb), and
// far_update reads B for the far classes of a split DSS.  The split costs
// one extra write and read of the nb exchanged rows (nb = 32 of 81 at
// p = 8) and keeps every cross-element read out of the product kernel.
// The RHS of a stack is blockIdx.y in both launches.  Tensor cores are not
// the route: the tensor form is under the byte bound on the CUDA cores,
// and a 3xTF32 mma over the assembled K would do 3 x 3.9 GFLOP to stay
// exact in f32.  No TPU mechanism is carried over: no lane windows or halo
// triples, no far split in the kernel, no procedural masks, no bf16x3
// split (the FMAs are true f32).
//
// sem_affine_block_apply_dss, the second entry point, replaces
// make_fused_affine_block_kernel (pallas_kernels.py:1110, pallas_call at
// :1150), the per-shard apply of the element-sharded operator
// (parallel/halo.py make_sharded_fused_operator): the same two launches
// with k = 1 on one shard's halo-extended (n, E_ext) block, with that
// shard's slices of the affine scales (3, E_ext) and class masks
// (C, E_ext).  A source outside the block counts as zero: the halo
// columns' sums are partial, and the caller keeps only the centre, whose
// sources all lie inside when the halo is the largest |delta|.  One of four
// shards of the 316 x 316 rectangle (E_ext = 25,598) moves 17 MB, 5 us,
// against 0.16 GFLOP, 2.4 us: bound by bytes too.
#include <cstring>

#include "sem_affine.cuh"

namespace sem {

template <int N>
__global__ void __launch_bounds__(aff_threads<N>(), 4)
    affine_local_kernel(const float* __restrict__ u, const AffineTables t,
                        const float* __restrict__ aT,
                        float* __restrict__ out, float* __restrict__ B,
                        int E, int nb) {
  constexpr int M = AffSmem<N>::M;
  __shared__ AffSmem<N> sm;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * kAffTile + lane;
  const bool valid = e < E;
  u += (size_t)blockIdx.y * N * E;
  out += (size_t)blockIdx.y * N * E;
  B += (size_t)blockIdx.y * nb * E;
  float x[M], S[M], y[M];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (valid) {
    a0 = aT[e];
    a1 = aT[E + e];
    a2 = aT[2 * E + e];
  }
#pragma unroll
  for (int a = 0; a < M; ++a)
    x[a] = valid ? u[(size_t)t.row[a * M + w] * E + e] : 0.f;
  aff_product<N>(sm, t, x, a0, a1, a2, S, y);
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
cudaError_t launch_affine_local(const float* u, const AffineTables& t,
                                const float* aT, float* out, float* B, int E,
                                int nb, int k, cudaStream_t stream) {
  const dim3 grid((E + kAffTile - 1) / kAffTile, k);
  affine_local_kernel<N><<<grid, aff_threads<N>(), 0, stream>>>(
      u, t, aT, out, B, E, nb);
  return cudaGetLastError();
}

// The local product of both entry points: tables is a host pointer to an
// AffineTables (copied here, then passed by value).
inline cudaError_t affine_local(const void* u, const void* tables,
                                const void* aT, void* out, void* B, int n,
                                int E, int nb, int k, cudaStream_t s) {
  AffineTables t;
  std::memcpy(&t, tables, sizeof t);
  const float* uf = static_cast<const float*>(u);
  const float* af = static_cast<const float*>(aT);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  switch (n) {
#define SEM_CASE(NN) \
  case NN:           \
    return launch_affine_local<NN>(uf, t, af, of, Bf, E, nb, k, s);
    SEM_APPLY_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace sem

// The size of AffineTables, for the host side's check of its layout.
extern "C" int sem_affine_tables_size() {
  return static_cast<int>(sizeof(sem::AffineTables));
}

// u, out: (k * n, E) f32; tables: host pointer to an AffineTables; aT:
// (3, E) f32; B: (k, nb, E) f32 scratch; row_ptr: (nb + 1,) int32;
// entries: (T, 4) int32; masks: (C, E) bool.  Returns a cudaError_t code
// (0 on success).
extern "C" int sem_affine_apply_dss(const void* u, const void* tables,
                                    const void* aT, void* out, void* B,
                                    const void* row_ptr, const void* entries,
                                    const void* masks, int n, int E, int nb,
                                    int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = sem::affine_local(u, tables, aT, out, B, n, E, nb, k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sem::launch_dss_gather(
      static_cast<const float*>(B), static_cast<float*>(out),
      static_cast<const int*>(row_ptr), static_cast<const int4*>(entries),
      static_cast<const bool*>(masks), n, E, nb, k, s));
}

// The apply on one shard's extended block (make_fused_affine_block_kernel).
// u, out: (n, E) f32 (E = the extended block); tables: as above; aT: (3, E)
// f32; M: (C, E) bool; B: (nb, E) f32 scratch; row_ptr: (nb + 1,) int32;
// entries: (T, 4) int32.  Returns a cudaError_t code (0 on success).
extern "C" int sem_affine_block_apply_dss(const void* u, const void* tables,
                                          const void* aT, const void* M,
                                          void* out, void* B,
                                          const void* row_ptr,
                                          const void* entries, int n, int E,
                                          int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = sem::affine_local(u, tables, aT, out, B, n, E, nb, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sem::launch_dss_gather(
      static_cast<const float*>(B), static_cast<float*>(out),
      static_cast<const int*>(row_ptr), static_cast<const int4*>(entries),
      static_cast<const bool*>(M), n, E, nb, 1, s));
}
