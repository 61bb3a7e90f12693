// affine_apply_dss: out = DSS(sum_c a_c K_c u) on transposed (n, E) f32
// L-vectors, for affine meshes, or on a (k * n, E) stack of k of them that
// share the operator (K, the affine scales, the class tables).
//
// Replaces the TPU kernel make_fused_affine_laplacian_T
// (spectralelementmethod_tpu/ops/pallas_kernels.py:986, pallas_call at
// :1086; n_rhs = k for the stack), the operator apply of every plain-CG
// iteration on the main path (k = 1) and of the batched plain CG.
//
// What bounds it on an H100 (p = 8, n = 81, E = 99,856): the assembled-K form
// does 2 * 3 * n^2 * E = 3.93 GFLOP of f32 FMAs, 59 us at the SXM part's
// 67 TFLOP/s on the CUDA cores, against 20 us for the 67.6 MB it must move
// (u, out, a and the class masks) at 3.35 TB/s: it is bound by operations.
// A k-stack does k times both.
//
// Design: two launches.  affine_local_kernel runs one thread per element
// with the element's n values in registers and K in dynamic shared memory
// (see sem_kernels.cuh); it writes the element-interior rows [nb, n) of S
// straight to out and the exchanged rows [0, nb) to the scratch B.
// dss_gather_kernel then sums the roll classes into out[0, nb).  The split
// costs one extra write and read of the nb exchanged rows (nb = 32 of 81 at
// p = 8) and keeps every cross-element read out of the product kernel.  No
// TPU mechanism is carried over: no lane windows or halo triples, no far
// split, no procedural masks, no bf16x3 split (the FMAs are true f32).
// The RHS of a stack is blockIdx.y in both launches.
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
// shards of the 316 x 316 rectangle (E_ext = 25,598) does 1.0 GFLOP, 15 us
// at 67 TFLOP/s, against 5 us for its 17 MB: bound by operations too.
#include "sem_kernels.cuh"

namespace sem {

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    affine_local_kernel(const float* __restrict__ u,
                        const float* __restrict__ K,
                        const float* __restrict__ aT,
                        float* __restrict__ out, float* __restrict__ B,
                        int E, int nb) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  load_K<N>(K, Ks);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  u += (size_t)blockIdx.y * N * E;
  out += (size_t)blockIdx.y * N * E;
  B += (size_t)blockIdx.y * nb * E;
  constexpr int NP = pad4(N);
  float uv[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) uv[j] = j < N ? u[(size_t)j * E + e] : 0.f;
  const float a0 = aT[e], a1 = aT[E + e], a2 = aT[2 * E + e];
  for (int i = 0; i < N; ++i) {
    const float s = affine_row<N>(Ks, i, uv, a0, a1, a2);
    if (i < nb)
      B[(size_t)i * E + e] = s;
    else
      out[(size_t)i * E + e] = s;
  }
}

template <int N>
cudaError_t launch_affine_local(const float* u, const float* K,
                                const float* aT, float* out, float* B, int E,
                                int nb, int k, cudaStream_t stream) {
  constexpr size_t smem = k_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      affine_local_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((E + kThreads - 1) / kThreads, k);
  affine_local_kernel<N><<<grid, kThreads, smem, stream>>>(u, K, aT, out, B,
                                                           E, nb);
  return cudaGetLastError();
}

}  // namespace sem

// u, out: (k * n, E) f32; K: (3, n, n) f32 (the blocks K_c); aT: (3, E)
// f32; B: (k, nb, E) f32 scratch; row_ptr: (nb + 1,) int32; entries: (T, 4)
// int32; masks: (C, E) bool.  Returns a cudaError_t code (0 on success).
extern "C" int sem_affine_apply_dss(const void* u, const void* K,
                                    const void* aT, void* out, void* B,
                                    const void* row_ptr, const void* entries,
                                    const void* masks, int n, int E, int nb,
                                    int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* Kf = static_cast<const float*>(K);
  const float* af = static_cast<const float*>(aT);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                       \
  case NN:                                                                 \
    err = sem::launch_affine_local<NN>(uf, Kf, af, of, Bf, E, nb, k, s);   \
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

// The apply on one shard's extended block (make_fused_affine_block_kernel).
// u, out: (n, E) f32 (E = the extended block); K: (3, n, n) f32; aT: (3, E)
// f32; M: (C, E) bool; B: (nb, E) f32 scratch; row_ptr: (nb + 1,) int32;
// entries: (T, 4) int32.  Returns a cudaError_t code (0 on success).
extern "C" int sem_affine_block_apply_dss(const void* u, const void* K,
                                          const void* aT, const void* M,
                                          void* out, void* B,
                                          const void* row_ptr,
                                          const void* entries, int n, int E,
                                          int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* Kf = static_cast<const float*>(K);
  const float* af = static_cast<const float*>(aT);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                       \
  case NN:                                                                 \
    err = sem::launch_affine_local<NN>(uf, Kf, af, of, Bf, E, nb, 1, s);   \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sem::launch_dss_gather(
      Bf, of, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(M), n, E,
      nb, 1, s));
}
