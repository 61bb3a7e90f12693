// cg_kernel_a: the direction half of one fused Jacobi-PCG iteration on
// transposed (n, E) L-vectors (affine meshes):
//
//   x'  = x + alpha_prev * p              (x lags one direction)
//   p'  = inv * r + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(sum_c a_c K_c p'_stored)
//   dparts[g] = sum over block g of p'_stored * S   (S before the DSS)
//
// Replaces the TPU kernel A of make_fused_cg_kernels
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1480, pallas_call at
// :1525).  Ap' is computed from the *stored* (rounded) p', and the
// denominator partials are taken over that same p' against the pre-DSS S
// (p^T A p = sum_e p_e . S_e for a consistent p), so the bf16 mode keeps the
// r recurrence consistent with the x updates.
//
// What bounds it on an H100 (p = 8, E = 99,856): with f32 p it moves seven
// (n, E) passes (r, p, inv, x in; p', Ap', x' out), 226 MB or 68 us at
// 3.35 TB/s, against 59 us for the 3.93 GFLOP of the assembled-K product:
// bound by bytes.  With bf16 p and inv it moves 178 MB (53 us) and the
// product's 59 us bounds it.
//
// Design: as affine_apply_dss (sem_kernels.cuh) — one thread per element,
// p' in registers, K in dynamic shared memory, the exchanged rows of S into
// the scratch B and the class gather as a second launch.  The partials are
// one per block of kThreads elements; the CG loop sums them.
#include "sem_kernels.cuh"

namespace sem {

template <int N, typename PT>
__global__ void __launch_bounds__(kThreads, 2)
    cg_a_local_kernel(const float* __restrict__ r, const PT* __restrict__ p,
                      const PT* __restrict__ inv, const float* __restrict__ x,
                      const float* __restrict__ K,
                      const float* __restrict__ aT,
                      const float* __restrict__ beta_p,
                      const float* __restrict__ alpha_prev_p,
                      PT* __restrict__ p_out, float* __restrict__ x_out,
                      float* __restrict__ ap_out, float* __restrict__ B,
                      float* __restrict__ dparts, int E, int nb) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  load_K<N>(K, Ks);
  const float beta = *beta_p, alpha_prev = *alpha_prev_p;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float d = 0.f;
  if (e < E) {
    constexpr int NP = pad4(N);
    float pv[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < N) {
        const size_t o = (size_t)j * E + e;
        const float pj = to_f32(p[o]);
        // explicit roundings (no FMA contraction): each product and sum
        // is rounded as the reference formula rounds it, so the stored
        // direction matches the plain version bit for bit
        x_out[o] = __fadd_rn(x[o], __fmul_rn(alpha_prev, pj));
        const PT st = from_f32<PT>(
            __fadd_rn(__fmul_rn(to_f32(inv[o]), r[o]), __fmul_rn(beta, pj)));
        p_out[o] = st;
        pv[j] = to_f32(st);
      } else {
        pv[j] = 0.f;
      }
    }
    const float a0 = aT[e], a1 = aT[E + e], a2 = aT[2 * E + e];
    for (int i = 0; i < N; ++i) {
      const float s = affine_row<N>(Ks, i, pv, a0, a1, a2);
      const size_t o = (size_t)i * E + e;
      // this thread wrote p_out[o] above; read it back rather than index
      // the register array with a run-time row
      d = fmaf(to_f32(p_out[o]), s, d);
      if (i < nb)
        B[o] = s;
      else
        ap_out[o] = s;
    }
  }
  const float tot = block_sum(d);
  if (threadIdx.x == 0) dparts[blockIdx.x] = tot;
}

template <int N, typename PT>
cudaError_t launch_cg_a_local(const float* r, const PT* p, const PT* inv,
                              const float* x, const float* K, const float* aT,
                              const float* beta, const float* alpha_prev,
                              PT* p_out, float* x_out, float* ap_out,
                              float* B, float* dparts, int E, int nb,
                              cudaStream_t stream) {
  constexpr size_t smem = k_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      cg_a_local_kernel<N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (E + kThreads - 1) / kThreads;
  cg_a_local_kernel<N, PT><<<grid, kThreads, smem, stream>>>(
      r, p, inv, x, K, aT, beta, alpha_prev, p_out, x_out, ap_out, B, dparts,
      E, nb);
  return cudaGetLastError();
}

template <typename PT>
int cg_kernel_a(const void* r, const void* p, const void* inv, const void* x,
                const void* K, const void* aT, const void* beta,
                const void* alpha_prev, void* p_out, void* x_out,
                void* ap_out, void* B, void* dparts, const void* row_ptr,
                const void* entries, const void* masks, int n, int E, int nb,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = launch_cg_a_local<NN, PT>(                                        \
        static_cast<const float*>(r), static_cast<const PT*>(p),            \
        static_cast<const PT*>(inv), static_cast<const float*>(x),          \
        static_cast<const float*>(K), static_cast<const float*>(aT),        \
        static_cast<const float*>(beta),                                    \
        static_cast<const float*>(alpha_prev), static_cast<PT*>(p_out),     \
        static_cast<float*>(x_out), apf, Bf, static_cast<float*>(dparts), E, \
        nb, s);                                                             \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dss_gather(
      Bf, apf, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), E,
      nb, s));
}

}  // namespace sem

// r, x, x_out, ap_out: (n, E) f32; p, inv, p_out: (n, E) f32 (_f32) or bf16
// (_bf16); K: (3, n, n) f32; aT: (3, E) f32; beta, alpha_prev: f32 scalars
// on the device; B: (nb, E) f32 scratch; dparts: (ceil(E / 256),) f32.
// Returns a cudaError_t code (0 on success).
#define SEM_CG_A_ENTRY(NAME, PT)                                              \
  extern "C" int NAME(const void* r, const void* p, const void* inv,         \
                      const void* x, const void* K, const void* aT,          \
                      const void* beta, const void* alpha_prev, void* p_out, \
                      void* x_out, void* ap_out, void* B, void* dparts,      \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb,               \
                      void* stream) {                                        \
    return sem::cg_kernel_a<PT>(r, p, inv, x, K, aT, beta, alpha_prev, p_out, \
                                x_out, ap_out, B, dparts, row_ptr, entries,  \
                                masks, n, E, nb, stream);                    \
  }
SEM_CG_A_ENTRY(sem_cg_kernel_a_f32, float)
SEM_CG_A_ENTRY(sem_cg_kernel_a_bf16, __nv_bfloat16)
