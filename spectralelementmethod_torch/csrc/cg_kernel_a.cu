// cg_kernel_a: the direction half of one fused Jacobi-PCG iteration on
// transposed (n, E) L-vectors (affine meshes), for one right-hand side or a
// (k * n, E) stack of k that share the operator and the preconditioner:
//
//   x'  = x + alpha_prev * p              (x lags one direction)
//   p'  = inv * r + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(sum_c a_c K_c p'_stored)
//   dparts[g, j] = sum over block g of p'_stored * S   (S before the DSS)
//
// per RHS j, with beta and alpha_prev (k,) vectors on the device and inv
// (n, E) shared.  With DEFER the x stream is left out (kA(r, p, inv, beta) ->
// p', Ap', dparts): the CG driver keeps the last m directions and catches x
// up once per m iterations.
//
// Replaces the TPU kernel A of make_fused_cg_kernels
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1480, pallas_call at
// :1525; deferred: :1423, pallas_call :1463) and of
// make_fused_cg_kernels_batched (:2000; with x :2153, pallas_call :2158;
// deferred :2128, pallas_call :2132).  Ap' is computed from the *stored*
// (rounded) p', and the denominator partials are taken over that same p'
// against the pre-DSS S (p^T A p = sum_e p_e . S_e for a consistent p), so
// the bf16 mode keeps the r recurrence consistent with the x updates.
//
// What bounds it on an H100 (p = 8, E = 99,856): with f32 p it moves seven
// (n, E) passes per RHS (r, p, inv, x in; p', Ap', x' out), 226 MB or 68 us
// at 3.35 TB/s, against 59 us for the 3.93 GFLOP of the assembled-K product:
// bound by bytes.  With bf16 p and inv it moves 178 MB (53 us) and the
// product's 59 us bounds it; deferred, five f32 passes (162 MB, 48 us) or
// 14 B per node with bf16, so the product bounds both.  A k-stack moves the
// shared inv once and does k products: at k = 4, 809 MB (0.24 ms, bytes)
// with f32 p and x, 15.7 GFLOP (0.235 ms, operations) deferred with bf16.
//
// Design: as affine_apply_dss (sem_kernels.cuh) — one thread per element,
// p' in registers, K in dynamic shared memory, the exchanged rows of S into
// the scratch B and the class gather as a second launch.  The RHS of a stack
// is blockIdx.y: each block holds one RHS's 81 direction values per thread,
// which already fill the 128 registers of two blocks per SM, so a thread
// does not loop over the k RHS.  The partials are one per block of kThreads
// elements and RHS, laid out (G, k); the CG loop sums them.
#include "sem_kernels.cuh"

namespace sem {

template <int N, typename PT, bool DEFER>
__global__ void __launch_bounds__(kThreads, 2)
    cg_a_local_kernel(const float* __restrict__ r, const PT* __restrict__ p,
                      const PT* __restrict__ inv, const float* __restrict__ x,
                      const float* __restrict__ K,
                      const float* __restrict__ aT,
                      const float* __restrict__ beta_v,
                      const float* __restrict__ alpha_prev_v,
                      PT* __restrict__ p_out, float* __restrict__ x_out,
                      float* __restrict__ ap_out, float* __restrict__ B,
                      float* __restrict__ dparts, int E, int nb) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  load_K<N>(K, Ks);
  const int rhs = blockIdx.y;
  const size_t off = (size_t)rhs * N * E;
  r += off;
  p += off;
  p_out += off;
  ap_out += off;
  B += (size_t)rhs * nb * E;
  if (!DEFER) {
    x += off;
    x_out += off;
  }
  const float beta = beta_v[rhs];
  const float alpha_prev = DEFER ? 0.f : alpha_prev_v[rhs];
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
        if (!DEFER) x_out[o] = __fadd_rn(x[o], __fmul_rn(alpha_prev, pj));
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
  if (threadIdx.x == 0) dparts[(size_t)blockIdx.x * gridDim.y + rhs] = tot;
}

template <int N, typename PT, bool DEFER>
cudaError_t launch_cg_a_local(const float* r, const PT* p, const PT* inv,
                              const float* x, const float* K, const float* aT,
                              const float* beta, const float* alpha_prev,
                              PT* p_out, float* x_out, float* ap_out,
                              float* B, float* dparts, int E, int nb, int k,
                              cudaStream_t stream) {
  constexpr size_t smem = k_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      cg_a_local_kernel<N, PT, DEFER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((E + kThreads - 1) / kThreads, k);
  cg_a_local_kernel<N, PT, DEFER><<<grid, kThreads, smem, stream>>>(
      r, p, inv, x, K, aT, beta, alpha_prev, p_out, x_out, ap_out, B, dparts,
      E, nb);
  return cudaGetLastError();
}

template <typename PT, bool DEFER>
int cg_kernel_a(const void* r, const void* p, const void* inv, const void* x,
                const void* K, const void* aT, const void* beta,
                const void* alpha_prev, void* p_out, void* x_out,
                void* ap_out, void* B, void* dparts, const void* row_ptr,
                const void* entries, const void* masks, int n, int E, int nb,
                int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = launch_cg_a_local<NN, PT, DEFER>(                                 \
        static_cast<const float*>(r), static_cast<const PT*>(p),            \
        static_cast<const PT*>(inv), static_cast<const float*>(x),          \
        static_cast<const float*>(K), static_cast<const float*>(aT),        \
        static_cast<const float*>(beta),                                    \
        static_cast<const float*>(alpha_prev), static_cast<PT*>(p_out),     \
        static_cast<float*>(x_out), apf, Bf, static_cast<float*>(dparts), E, \
        nb, k, s);                                                          \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dss_gather(
      Bf, apf, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), n,
      E, nb, k, s));
}

}  // namespace sem

// r, x, x_out, ap_out: (k * n, E) f32; p, p_out: (k * n, E) f32 (_f32) or
// bf16 (_bf16); inv: (n, E) of p's type; K: (3, n, n) f32; aT: (3, E) f32;
// beta, alpha_prev: (k,) f32 on the device; B: (k, nb, E) f32 scratch;
// dparts: (ceil(E / 256), k) f32.  Returns a cudaError_t code (0 on
// success).
#define SEM_CG_A_ENTRY(NAME, PT)                                              \
  extern "C" int NAME(const void* r, const void* p, const void* inv,         \
                      const void* x, const void* K, const void* aT,          \
                      const void* beta, const void* alpha_prev, void* p_out, \
                      void* x_out, void* ap_out, void* B, void* dparts,      \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb, int k,        \
                      void* stream) {                                        \
    return sem::cg_kernel_a<PT, false>(                                      \
        r, p, inv, x, K, aT, beta, alpha_prev, p_out, x_out, ap_out, B,      \
        dparts, row_ptr, entries, masks, n, E, nb, k, stream);               \
  }
SEM_CG_A_ENTRY(sem_cg_kernel_a_f32, float)
SEM_CG_A_ENTRY(sem_cg_kernel_a_bf16, __nv_bfloat16)

// The deferred kernel: as above without x, x_out and alpha_prev.
#define SEM_CG_A_DEFER_ENTRY(NAME, PT)                                        \
  extern "C" int NAME(const void* r, const void* p, const void* inv,         \
                      const void* K, const void* aT, const void* beta,       \
                      void* p_out, void* ap_out, void* B, void* dparts,      \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb, int k,        \
                      void* stream) {                                        \
    return sem::cg_kernel_a<PT, true>(                                       \
        r, p, inv, nullptr, K, aT, beta, nullptr, p_out, nullptr, ap_out, B, \
        dparts, row_ptr, entries, masks, n, E, nb, k, stream);               \
  }
SEM_CG_A_DEFER_ENTRY(sem_cg_kernel_a_defer_f32, float)
SEM_CG_A_DEFER_ENTRY(sem_cg_kernel_a_defer_bf16, __nv_bfloat16)
