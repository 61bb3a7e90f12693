// cg_kernel_a: the direction half of one fused Jacobi-PCG iteration on
// transposed (n, E) L-vectors (affine meshes), for one right-hand side or a
// (k * n, E) stack of k that share the operator and the preconditioner:
//
//   x'  = x + alpha_prev * p              (x lags one direction)
//   p'  = inv * r + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(sum_c a_c K_c p'_stored)
//   dparts[g, j] = sum over tile g of p'_stored . S   (S before the DSS)
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
// What bounds it on an H100 (p = 8, E = 99,856, one (n, E) f32 pass 32.35
// MB): bytes.  With f32 p it moves seven passes per RHS (r, p, inv, x in;
// p', Ap', x' out), 226 MB or 68 us at 3.35 TB/s; with bf16 p and inv,
// 178 MB (53 us); deferred, 162 MB (48 us) in f32 and 113 MB (34 us) in
// bf16.  The product in tensor-product form does 6.3 kflop per element,
// 0.63 GFLOP or 9 us at 67 TFLOP/s.  A k-stack reads the shared inv once
// and does k of everything else: at k = 4, 809 MB (0.24 ms) with f32 p and
// x, 404 MB (0.12 ms) deferred with bf16.
//
// Design: affine_apply_dss's product kernel (sem_affine.cuh) with the
// vector update in front and the denominator behind.  A block takes a tile
// of 32 elements and M warps.  Warp w forms the update on its column line
// (a, w): it reads r, p, inv and x at rows row[a M + w], each a 128-byte
// segment (64 bytes for bf16), writes p' and x' there and hands the stored
// p' to aff_product as its operand.  aff_product returns S on the row line
// (w, c) together with that line's p' (its own hand-over), so the
// denominator p'[w, c] S[c] needs no read-back; S goes to B (rows < nb) or
// to Ap' as in the apply, and the gather launch sums the exchanged rows.
// The product is the apply's, so Ap' equals affine_apply_dss of the stored
// p' bit for bit.  One partial per tile and RHS: dparts is (ceil(E / 32),
// k), and the CG loop sums it over its rows.  A k-stack takes the RHS from
// blockIdx.y and re-reads the shared inv once per RHS: a block that loops
// over the k RHS instead needs 96 registers and 2 blocks per SM, and was
// 14-18% slower on an H100 at k = 4.  The launch bounds hold it to 72
// registers and 3 blocks (27 warps) per SM without spills (the apply's 56
// registers and 4 blocks spill here: the row-line p' stays live through
// the product).
#include "sem_affine.cuh"

#include <cstring>

namespace sem {

constexpr int kCgAMinBlocks = 3;

template <int N, typename PT, bool DEFER>
__global__ void __launch_bounds__(aff_threads<N>(), kCgAMinBlocks)
    cg_a_local_kernel(const float* __restrict__ r, const PT* __restrict__ p,
                      const PT* __restrict__ inv, const float* __restrict__ x,
                      const AffineTables t, const float* __restrict__ aT,
                      const float* __restrict__ beta_v,
                      const float* __restrict__ alpha_prev_v,
                      PT* __restrict__ p_out, float* __restrict__ x_out,
                      float* __restrict__ ap_out, float* __restrict__ B,
                      float* __restrict__ dparts, int E, int nb) {
  constexpr int M = AffSmem<N>::M;
  __shared__ AffSmem<N> sm;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * kAffTile + lane;
  const bool valid = e < E;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (valid) {
    a0 = aT[e];
    a1 = aT[E + e];
    a2 = aT[2 * E + e];
  }
  const int rhs = blockIdx.y;
  const size_t off = (size_t)rhs * N * E;
  const float beta = beta_v[rhs];
  const float alpha_prev = DEFER ? 0.f : alpha_prev_v[rhs];
  // the column line (a, w): the vector update, and the stored p' as the
  // product's operand
  float xv[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    xv[a] = 0.f;
    if (valid) {
      const size_t o = (size_t)t.row[a * M + w] * E + e;
      const float pj = to_f32(p[off + o]);
      // explicit roundings (no FMA contraction): each product and sum is
      // rounded as the reference formula rounds it, so the stored
      // direction and x' match the plain version bit for bit
      if (!DEFER)
        x_out[off + o] = __fadd_rn(x[off + o], __fmul_rn(alpha_prev, pj));
      const PT st = from_f32<PT>(__fadd_rn(
          __fmul_rn(to_f32(inv[o]), r[off + o]), __fmul_rn(beta, pj)));
      p_out[off + o] = st;
      xv[a] = to_f32(st);
    }
  }
  float S[M], y[M];
  aff_product<N>(sm, t, xv, a0, a1, a2, S, y);
  // the row line (w, c): S out, and the denominator against its p'
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < M; ++c) {
    d = fmaf(y[c], S[c], d);
    if (valid) {
      const int j = t.row[w * M + c];
      if (j < nb)
        B[((size_t)rhs * nb + j) * E + e] = S[c];
      else
        ap_out[off + (size_t)j * E + e] = S[c];
    }
  }
  const float tot = block_sum(d);
  if (threadIdx.x == 0) dparts[(size_t)blockIdx.x * gridDim.y + rhs] = tot;
}

template <int N, typename PT, bool DEFER>
cudaError_t launch_cg_a_local(const float* r, const PT* p, const PT* inv,
                              const float* x, const AffineTables& t,
                              const float* aT, const float* beta,
                              const float* alpha_prev, PT* p_out,
                              float* x_out, float* ap_out, float* B,
                              float* dparts, int E, int nb, int k,
                              cudaStream_t stream) {
  const dim3 grid((E + kAffTile - 1) / kAffTile, k);
  cg_a_local_kernel<N, PT, DEFER><<<grid, aff_threads<N>(), 0, stream>>>(
      r, p, inv, x, t, aT, beta, alpha_prev, p_out, x_out, ap_out, B, dparts,
      E, nb);
  return cudaGetLastError();
}

template <typename PT, bool DEFER>
int cg_kernel_a(const void* r, const void* p, const void* inv, const void* x,
                const void* tables, const void* aT, const void* beta,
                const void* alpha_prev, void* p_out, void* x_out,
                void* ap_out, void* B, void* dparts, const void* row_ptr,
                const void* entries, const void* masks, int n, int E, int nb,
                int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AffineTables t;
  std::memcpy(&t, tables, sizeof t);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    err = launch_cg_a_local<NN, PT, DEFER>(                                 \
        static_cast<const float*>(r), static_cast<const PT*>(p),            \
        static_cast<const PT*>(inv), static_cast<const float*>(x), t,       \
        static_cast<const float*>(aT), static_cast<const float*>(beta),     \
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
// bf16 (_bf16); inv: (n, E) of p's type; tables: host pointer to the
// operator's AffineTables (sem_affine.cuh); aT: (3, E) f32; beta,
// alpha_prev: (k,) f32 on the device; B: (k, nb, E) f32 scratch; dparts:
// (ceil(E / 32), k) f32, one row per tile of 32 elements.  Returns a
// cudaError_t code (0 on success).
#define SEM_CG_A_ENTRY(NAME, PT)                                              \
  extern "C" int NAME(const void* r, const void* p, const void* inv,         \
                      const void* x, const void* tables, const void* aT,     \
                      const void* beta, const void* alpha_prev, void* p_out, \
                      void* x_out, void* ap_out, void* B, void* dparts,      \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb, int k,        \
                      void* stream) {                                        \
    return sem::cg_kernel_a<PT, false>(                                      \
        r, p, inv, x, tables, aT, beta, alpha_prev, p_out, x_out, ap_out, B, \
        dparts, row_ptr, entries, masks, n, E, nb, k, stream);               \
  }
SEM_CG_A_ENTRY(sem_cg_kernel_a_f32, float)
SEM_CG_A_ENTRY(sem_cg_kernel_a_bf16, __nv_bfloat16)

// The deferred kernel: as above without x, x_out and alpha_prev.
#define SEM_CG_A_DEFER_ENTRY(NAME, PT)                                        \
  extern "C" int NAME(const void* r, const void* p, const void* inv,         \
                      const void* tables, const void* aT, const void* beta,  \
                      void* p_out, void* ap_out, void* B, void* dparts,      \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb, int k,        \
                      void* stream) {                                        \
    return sem::cg_kernel_a<PT, true>(                                       \
        r, p, inv, nullptr, tables, aT, beta, nullptr, p_out, nullptr,       \
        ap_out, B, dparts, row_ptr, entries, masks, n, E, nb, k, stream);    \
  }
SEM_CG_A_DEFER_ENTRY(sem_cg_kernel_a_defer_f32, float)
SEM_CG_A_DEFER_ENTRY(sem_cg_kernel_a_defer_bf16, __nv_bfloat16)

// The size of AffineTables, for the host side's check of its layout.
extern "C" int sem_affine_tables_size() {
  return static_cast<int>(sizeof(sem::AffineTables));
}
