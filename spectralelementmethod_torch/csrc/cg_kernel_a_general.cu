// cg_kernel_a_general: the direction half of one fused Jacobi-PCG iteration
// on a curved (non-affine) mesh, on transposed (n, E) L-vectors, for one
// right-hand side or a (k * n, E) stack of k that share the operator and the
// preconditioner:
//
//   x'  = x + alpha_prev * p              (x lags one direction)
//   p'  = inv * r + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us]), [ur; us] = Dhat p'
//   dparts[g, j] = sum over block g of p'_stored * S   (S before the DSS)
//
// per RHS j, with beta and alpha_prev (k,) vectors on the device and inv
// (n, E) shared.  There is no deferred-x variant, as in the reference.
//
// Replaces the TPU kernel A of make_fused_cg_kernels_general
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1824, pallas_call at
// :1973; n_rhs = k for the stack).  Ap' and the partials come from the
// *stored* (rounded) p', so the bf16 mode keeps the r recurrence consistent
// with the x updates.
//
// What bounds it on an H100 (p = 8, E = 99,856): per node it reads r, p,
// inv, x and the three factor slabs and writes p', Ap', x': 40 B (34 B with
// bf16 p and inv), 324 MB or 97 us at 3.35 TB/s, against 6.3 kflop per
// element for the apply (9 us at 67 TFLOP/s): bound by bytes.  A k-stack
// reads inv and the slabs once: 24 k + 16 B per node (20 k + 14 with bf16).
//
// Design: as general_apply_dss (sem_general.cuh) — a tile of 32 elements per
// block, the RHS the fastest grid index; the load pass forms x' and the
// stored p' row by row (with the same explicit roundings as cg_kernel_a.cu,
// so p' matches the plain version bit for bit) and puts p' into the tile's
// shared memory in lex order; the gradient/flux and S passes follow, S's
// exchanged rows go to the scratch B for the class gather, and each block
// sums p' . S over its tile into one partial per RHS, laid out (G, k).
#include "sem_general.cuh"

namespace sem {

template <int N, typename PT>
__global__ void __launch_bounds__(kGenThreads)
    cg_a_general_kernel(const float* __restrict__ r,
                        const PT* __restrict__ p, const PT* __restrict__ inv,
                        const float* __restrict__ x,
                        const float* __restrict__ gT,
                        const float* __restrict__ Dh,
                        const int* __restrict__ hier,
                        const float* __restrict__ beta_v,
                        const float* __restrict__ alpha_prev_v,
                        PT* __restrict__ p_out, float* __restrict__ x_out,
                        float* __restrict__ ap_out, float* __restrict__ B,
                        float* __restrict__ dparts, int E, int nb, int k) {
  __shared__ GenSmem<N> s;
  gen_load_tables<N>(s, Dh, hier);
  const int tile = blockIdx.x / k, rhs = blockIdx.x % k;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = tile * kGenTile + lane;
  const bool valid = e < E;
  const size_t off = (size_t)rhs * N * E;
  r += off;
  p += off;
  x += off;
  p_out += off;
  x_out += off;
  ap_out += off;
  B += (size_t)rhs * nb * E;
  const float beta = beta_v[rhs], alpha_prev = alpha_prev_v[rhs];
  for (int j = w; j < N; j += kGenWarps) {
    float v = 0.f;
    if (valid) {
      const size_t o = (size_t)j * E + e;
      const float pj = to_f32(p[o]);
      // explicit roundings (no FMA contraction), as in cg_kernel_a.cu
      x_out[o] = __fadd_rn(x[o], __fmul_rn(alpha_prev, pj));
      const PT st = from_f32<PT>(
          __fadd_rn(__fmul_rn(to_f32(inv[o]), r[o]), __fmul_rn(beta, pj)));
      p_out[o] = st;
      v = to_f32(st);
    }
    s.u[s.hier[j]][lane] = v;
  }
  __syncthreads();
  gen_flux<N>(s, gT, E, e, valid);
  __syncthreads();
  float d = 0.f;
  if (valid) {
    for (int j = w; j < N; j += kGenWarps) {
      const float v = gen_row<N>(s, j, lane);
      d = fmaf(s.u[s.hier[j]][lane], v, d);
      if (j < nb)
        B[(size_t)j * E + e] = v;
      else
        ap_out[(size_t)j * E + e] = v;
    }
  }
  const float tot = block_sum(d);
  if (threadIdx.x == 0) dparts[(size_t)tile * k + rhs] = tot;
}

template <typename PT>
int cg_kernel_a_general(const void* r, const void* p, const void* inv,
                        const void* x, const void* gT, const void* Dh,
                        const void* hier, const void* beta,
                        const void* alpha_prev, void* p_out, void* x_out,
                        void* ap_out, void* B, void* dparts,
                        const void* row_ptr, const void* entries,
                        const void* masks, int n, int E, int nb, int k,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  const int blocks = (E + kGenTile - 1) / kGenTile * k;
  switch (n) {
#define SEM_CASE(NN)                                                         \
  case NN:                                                                   \
    cg_a_general_kernel<NN, PT><<<blocks, kGenThreads, 0, s>>>(              \
        static_cast<const float*>(r), static_cast<const PT*>(p),             \
        static_cast<const PT*>(inv), static_cast<const float*>(x),           \
        static_cast<const float*>(gT), static_cast<const float*>(Dh),        \
        static_cast<const int*>(hier), static_cast<const float*>(beta),      \
        static_cast<const float*>(alpha_prev), static_cast<PT*>(p_out),      \
        static_cast<float*>(x_out), apf, Bf, static_cast<float*>(dparts), E, \
        nb, k);                                                              \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dss_gather(
      Bf, apf, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), n,
      E, nb, k, s));
}

}  // namespace sem

// r, x, x_out, ap_out: (k * n, E) f32; p, p_out: (k * n, E) f32 (_f32) or
// bf16 (_bf16); inv: (n, E) of p's type; gT: (3, n, E) f32 lex-order factor
// slabs; Dh: (2n, n) f32 stacked derivative with columns in hier order;
// hier: (n,) int32; beta, alpha_prev: (k,) f32 on the device; B: (k, nb, E)
// f32 scratch; dparts: (ceil(E / 32), k) f32.  Returns a cudaError_t code
// (0 on success).
#define SEM_CG_A_GENERAL_ENTRY(NAME, PT)                                       \
  extern "C" int NAME(const void* r, const void* p, const void* inv,          \
                      const void* x, const void* gT, const void* Dh,          \
                      const void* hier, const void* beta,                     \
                      const void* alpha_prev, void* p_out, void* x_out,       \
                      void* ap_out, void* B, void* dparts,                    \
                      const void* row_ptr, const void* entries,               \
                      const void* masks, int n, int E, int nb, int k,         \
                      void* stream) {                                         \
    return sem::cg_kernel_a_general<PT>(                                      \
        r, p, inv, x, gT, Dh, hier, beta, alpha_prev, p_out, x_out, ap_out,   \
        B, dparts, row_ptr, entries, masks, n, E, nb, k, stream);             \
  }
SEM_CG_A_GENERAL_ENTRY(sem_cg_kernel_a_general_f32, float)
SEM_CG_A_GENERAL_ENTRY(sem_cg_kernel_a_general_bf16, __nv_bfloat16)
