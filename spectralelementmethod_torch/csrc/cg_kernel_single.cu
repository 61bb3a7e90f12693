// cg_kernel_single: one whole Jacobi-PCG iteration on transposed (n, E)
// L-vectors (affine meshes), with the residual update deferred into the
// next iteration's kernel:
//
//   r'  = r - alpha_prev * Ap          (Ap: the previous iteration's Ap')
//   p'  = inv * r' + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(sum_c a_c K_c p'_stored)
//   x'  = x + alpha_prev * p           (left out with DEFER)
//   parts[g, :] = block g's partial sums of
//         [denom, c1, c2, e1, e2] = [p'_stored . S (S before the DSS),
//                                    <r', inv Ap'>_w, <Ap', inv Ap'>_w,
//                                    <r', inv r'>_w, <r', r'>_w]
//
// with alpha_prev and beta float32 scalars on the device; inv and w (the
// masked inverse diagonal and the dot weights zeroed on Dirichlet rows) are
// of p's type.  The CG loop sums parts over its rows: alpha = e1 / denom,
// the stopping test reads e2, and the next beta uses the one-step
// prediction e1 - 2 alpha c1 + alpha^2 c2 of the next <r, z>.
//
// Replaces the TPU kernel of make_fused_cg_kernel_single
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1608; pallas_call at
// :1807, deferred :1765).  The TPU kernel reads r and Ap as halo windows
// so that its in-VMEM DSS sees the neighbours' r'; here the DSS is the
// gather pass over the exchanged rows of S, so r' and the residual update
// are pointwise.
//
// What bounds it on an H100 (p = 8, E = 99,856, one (n, E) f32 pass 32.35
// MB): with x and f32 p, inv, w it moves ten passes (r, Ap, p, x, inv, w in;
// r', p', Ap', x' out), 323.5 MB or 97 us at 3.35 TB/s, against 59 us for
// the 3.93 GFLOP of the assembled-K product: bound by bytes.  With bf16 p,
// inv and w, 258.8 MB (77 us); deferred, 258.8 MB in f32 and 194.1 MB
// (58 us) in bf16, where the product's flops bound it.
//
// Design: kernel A's (cg_kernel_a.cu) — one thread per element, p' in
// registers, K in dynamic shared memory, the exchanged rows [0, nb) of S to
// the scratch B and the class gather as a second launch.  The first pass
// over the rows forms r', p' and x' and the e1, e2 partials; the product
// pass accumulates denom and, on the element-interior rows [nb, n) whose
// Ap' it writes directly, c1 and c2 (reading back r', inv and w).  The
// gather launch forms Ap' on the exchanged rows and adds their c1 and c2:
// its blocks write rows [G, 2G) of parts (zeros in the other columns), so
// parts is (2G, 5), or (G, 5) when nothing is exchanged.
#include "sem_kernels.cuh"

namespace sem {

constexpr int kParts = 5;

template <int N, typename PT, bool DEFER>
__global__ void __launch_bounds__(kThreads, 2)
    cg_single_local_kernel(const float* __restrict__ r,
                           const float* __restrict__ ap,
                           const PT* __restrict__ p,
                           const float* __restrict__ x,
                           const PT* __restrict__ inv,
                           const PT* __restrict__ w,
                           const float* __restrict__ K,
                           const float* __restrict__ aT,
                           const float* __restrict__ alpha_prev_v,
                           const float* __restrict__ beta_v,
                           float* __restrict__ r_out, PT* __restrict__ p_out,
                           float* __restrict__ ap_out,
                           float* __restrict__ x_out, float* __restrict__ B,
                           float* __restrict__ parts, int E, int nb) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  load_K<N>(K, Ks);
  const float alpha_prev = *alpha_prev_v, beta = *beta_v;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float denom = 0.f, c1 = 0.f, c2 = 0.f, e1 = 0.f, e2 = 0.f;
  if (e < E) {
    constexpr int NP = pad4(N);
    float pv[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < N) {
        const size_t o = (size_t)j * E + e;
        const float pj = to_f32(p[o]);
        // explicit roundings (no FMA contraction): r', x' and the stored
        // direction match the plain version bit for bit
        const float rv = __fsub_rn(r[o], __fmul_rn(alpha_prev, ap[o]));
        r_out[o] = rv;
        if (!DEFER) x_out[o] = __fadd_rn(x[o], __fmul_rn(alpha_prev, pj));
        const float iv = to_f32(inv[o]);
        const PT st =
            from_f32<PT>(__fadd_rn(__fmul_rn(iv, rv), __fmul_rn(beta, pj)));
        p_out[o] = st;
        pv[j] = to_f32(st);
        const float wr = to_f32(w[o]) * rv;
        e1 = fmaf(wr, iv * rv, e1);
        e2 = fmaf(wr, rv, e2);
      } else {
        pv[j] = 0.f;
      }
    }
    const float a0 = aT[e], a1 = aT[E + e], a2 = aT[2 * E + e];
    for (int i = 0; i < N; ++i) {
      const float s = affine_row<N>(Ks, i, pv, a0, a1, a2);
      const size_t o = (size_t)i * E + e;
      // this thread wrote p_out, r_out above; read them back rather than
      // index the register array with a run-time row
      denom = fmaf(to_f32(p_out[o]), s, denom);
      if (i < nb) {
        B[o] = s;
      } else {
        ap_out[o] = s;
        const float q = to_f32(inv[o]) * s;
        const float wv = to_f32(w[o]);
        c1 = fmaf(wv * r_out[o], q, c1);
        c2 = fmaf(wv * s, q, c2);
      }
    }
  }
  const float sums[kParts] = {block_sum(denom), block_sum(c1), block_sum(c2),
                              block_sum(e1), block_sum(e2)};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kParts; ++c)
      parts[(size_t)blockIdx.x * kParts + c] = sums[c];
  }
}

// Ap'[d, e] = the DSS of the exchanged row d < nb, and block g's c1 and c2
// over those rows into row G + g of parts.
template <typename PT>
__global__ void __launch_bounds__(kThreads)
    cg_single_gather_kernel(const float* __restrict__ B,
                            float* __restrict__ ap_out,
                            const float* __restrict__ r_out,
                            const PT* __restrict__ inv,
                            const PT* __restrict__ w,
                            const int* __restrict__ row_ptr,
                            const int4* __restrict__ ent,
                            const bool* __restrict__ masks,
                            float* __restrict__ parts, int E, int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float c1 = 0.f, c2 = 0.f;
  if (e < E) {
    for (int d = 0; d < nb; ++d) {
      const float s = dss_gather_row(B, row_ptr, ent, masks, E, d, e);
      const size_t o = (size_t)d * E + e;
      ap_out[o] = s;
      const float q = to_f32(inv[o]) * s;
      const float wv = to_f32(w[o]);
      c1 = fmaf(wv * r_out[o], q, c1);
      c2 = fmaf(wv * s, q, c2);
    }
  }
  c1 = block_sum(c1);
  c2 = block_sum(c2);
  if (threadIdx.x == 0) {
    float* row = parts + (size_t)(gridDim.x + blockIdx.x) * kParts;
    row[0] = 0.f;
    row[1] = c1;
    row[2] = c2;
    row[3] = 0.f;
    row[4] = 0.f;
  }
}

template <int N, typename PT, bool DEFER>
cudaError_t launch_single_local(const float* r, const float* ap, const PT* p,
                                const float* x, const PT* inv, const PT* w,
                                const float* K, const float* aT,
                                const float* alpha_prev, const float* beta,
                                float* r_out, PT* p_out, float* ap_out,
                                float* x_out, float* B, float* parts, int E,
                                int nb, cudaStream_t stream) {
  constexpr size_t smem = k_smem_bytes<N>();
  cudaError_t err = cudaFuncSetAttribute(
      cg_single_local_kernel<N, PT, DEFER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (E + kThreads - 1) / kThreads;
  cg_single_local_kernel<N, PT, DEFER><<<grid, kThreads, smem, stream>>>(
      r, ap, p, x, inv, w, K, aT, alpha_prev, beta, r_out, p_out, ap_out,
      x_out, B, parts, E, nb);
  return cudaGetLastError();
}

template <typename PT, bool DEFER>
int cg_kernel_single(const void* r, const void* ap, const void* p,
                     const void* x, const void* inv, const void* w,
                     const void* K, const void* aT, const void* alpha_prev,
                     const void* beta, void* r_out, void* p_out,
                     void* ap_out, void* x_out, void* B, void* parts,
                     const void* row_ptr, const void* entries,
                     const void* masks, int n, int E, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PT* invp = static_cast<const PT*>(inv);
  const PT* wp = static_cast<const PT*>(w);
  float* rf = static_cast<float*>(r_out);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  float* pf = static_cast<float*>(parts);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = launch_single_local<NN, PT, DEFER>(                               \
        static_cast<const float*>(r), static_cast<const float*>(ap),        \
        static_cast<const PT*>(p), static_cast<const float*>(x), invp, wp,  \
        static_cast<const float*>(K), static_cast<const float*>(aT),        \
        static_cast<const float*>(alpha_prev),                              \
        static_cast<const float*>(beta), rf, static_cast<PT*>(p_out), apf,  \
        static_cast<float*>(x_out), Bf, pf, E, nb, s);                      \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || nb == 0) return static_cast<int>(err);
  const int grid = (E + kThreads - 1) / kThreads;
  cg_single_gather_kernel<PT><<<grid, kThreads, 0, s>>>(
      Bf, apf, rf, invp, wp, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), pf,
      E, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sem

// r, ap, x, r_out, ap_out, x_out: (n, E) f32; p, inv, w, p_out: (n, E) f32
// (_f32) or bf16 (_bf16); K: (3, n, n) f32; aT: (3, E) f32; alpha_prev,
// beta: f32 scalars on the device; B: (nb, E) f32 scratch; parts:
// (2 * ceil(E / 256), 5) f32, or (ceil(E / 256), 5) when nb = 0.  Returns
// a cudaError_t code (0 on success).
#define SEM_SINGLE_ENTRY(NAME, PT)                                            \
  extern "C" int NAME(const void* r, const void* ap, const void* p,          \
                      const void* x, const void* inv, const void* w,         \
                      const void* K, const void* aT, const void* alpha_prev, \
                      const void* beta, void* r_out, void* p_out,            \
                      void* ap_out, void* x_out, void* B, void* parts,       \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb,               \
                      void* stream) {                                        \
    return sem::cg_kernel_single<PT, false>(                                 \
        r, ap, p, x, inv, w, K, aT, alpha_prev, beta, r_out, p_out, ap_out,  \
        x_out, B, parts, row_ptr, entries, masks, n, E, nb, stream);         \
  }
SEM_SINGLE_ENTRY(sem_cg_kernel_single_f32, float)
SEM_SINGLE_ENTRY(sem_cg_kernel_single_bf16, __nv_bfloat16)

// The deferred kernel: as above without x and x_out.
#define SEM_SINGLE_DEFER_ENTRY(NAME, PT)                                      \
  extern "C" int NAME(const void* r, const void* ap, const void* p,          \
                      const void* inv, const void* w, const void* K,         \
                      const void* aT, const void* alpha_prev,                \
                      const void* beta, void* r_out, void* p_out,            \
                      void* ap_out, void* B, void* parts,                    \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb,               \
                      void* stream) {                                        \
    return sem::cg_kernel_single<PT, true>(                                  \
        r, ap, p, nullptr, inv, w, K, aT, alpha_prev, beta, r_out, p_out,    \
        ap_out, nullptr, B, parts, row_ptr, entries, masks, n, E, nb,        \
        stream);                                                             \
  }
SEM_SINGLE_DEFER_ENTRY(sem_cg_kernel_single_defer_f32, float)
SEM_SINGLE_DEFER_ENTRY(sem_cg_kernel_single_defer_bf16, __nv_bfloat16)
