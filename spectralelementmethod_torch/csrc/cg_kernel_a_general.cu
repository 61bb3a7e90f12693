// cg_kernel_a_general: the direction half of one fused Jacobi-PCG iteration
// on a curved (non-affine) mesh, on transposed (n, E) L-vectors, for one
// right-hand side or a (k * n, E) stack of k that share the operator and the
// preconditioner:
//
//   x'  = x + alpha_prev * p              (x lags one direction)
//   p'  = inv * r + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(Dhat^T [g0 ur + g1 us; g1 ur + g2 us]), [ur; us] = Dhat p'
//   dparts[g, j] = sum over tile g of p'_stored . S   (S before the DSS)
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
// Design: the affine kernel A's scheme (cg_kernel_a.cu) on the curved
// product of sem_curved.cuh.  A block takes a tile of 32 elements and M
// warps, the RHS the fastest grid index (block b: tile b / k, RHS b % k,
// so the k blocks of a tile read its factor slabs through L2 once).  Each
// thread issues its factor copies first; warp w then forms the update on its
// column line (a, w): it reads r, p, inv and x at rows row[a M + w], writes
// x' and the stored p' there (with the explicit roundings of cg_kernel_a.cu,
// so both match the plain version bit for bit) and hands the stored p' to
// gen_product.  gen_product returns S on the row line (w, c) with that
// line's p', so the denominator p'[w, c] S[c] needs no read-back; S goes to
// B (rows < nb) or to Ap', and the gather launch sums the exchanged rows.
// The product is the apply's, so Ap' equals general_apply_dss of the stored
// p' bit for bit.  One partial per tile and RHS: dparts is (ceil(E / 32),
// k).  It runs 4 blocks per SM where the apply runs 3: its longer load
// phase (r, p, inv, x) gains from the extra warps.
#include <cstring>

#include "sem_curved.cuh"

namespace sem {

// resident blocks per SM in the launch bounds (M warps each): 4, as many as
// the 52 KB of shared memory per block allow, hold it to 56 registers
// without spills at p = 8, and on an H100 ran 3-7% faster than 3 blocks at
// 72 registers (scripts/torch_general_variants.py)
constexpr int kGenCgAMinBlocks = 4;

template <int N, typename PT>
__global__ void __launch_bounds__(aff_threads<N>(), kGenCgAMinBlocks)
    cg_a_general_kernel(const float* __restrict__ r,
                        const PT* __restrict__ p, const PT* __restrict__ inv,
                        const float* __restrict__ x, const GeneralTables t,
                        const float* __restrict__ gT,
                        const float* __restrict__ beta_v,
                        const float* __restrict__ alpha_prev_v,
                        PT* __restrict__ p_out, float* __restrict__ x_out,
                        float* __restrict__ ap_out, float* __restrict__ B,
                        float* __restrict__ dparts, int E, int nb, int k) {
  constexpr int M = AffSmem<N>::M;
  CurvedSmem<N>& cs = *reinterpret_cast<CurvedSmem<N>*>(curved_smem);
  const int tile = blockIdx.x / k, rhs = blockIdx.x % k;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = tile * kAffTile + lane;
  const bool valid = e < E;
  gen_stage_factors<N>(cs, gT, E, e, valid);
  const size_t off = (size_t)rhs * N * E;
  const float beta = beta_v[rhs], alpha_prev = alpha_prev_v[rhs];
  // the column line (a, w): the vector update, and the stored p' as the
  // product's operand
  float xv[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    xv[a] = 0.f;
    if (valid) {
      const size_t o = (size_t)t.row[a * M + w] * E + e;
      const float pj = to_f32(p[off + o]);
      // explicit roundings (no FMA contraction), as in cg_kernel_a.cu
      x_out[off + o] = __fadd_rn(x[off + o], __fmul_rn(alpha_prev, pj));
      const PT st = from_f32<PT>(__fadd_rn(
          __fmul_rn(to_f32(inv[o]), r[off + o]), __fmul_rn(beta, pj)));
      p_out[off + o] = st;
      xv[a] = to_f32(st);
    }
  }
  float S[M], y[M];
  gen_product<N>(cs, t, xv, S, y);
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
  if (threadIdx.x == 0) dparts[(size_t)tile * k + rhs] = tot;
}

template <typename PT>
int cg_kernel_a_general(const void* r, const void* p, const void* inv,
                        const void* x, const void* tables, const void* gT,
                        const void* beta, const void* alpha_prev,
                        void* p_out, void* x_out, void* ap_out, void* B,
                        void* dparts, const void* row_ptr,
                        const void* entries, const void* masks, int n, int E,
                        int nb, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GeneralTables t;
  std::memcpy(&t, tables, sizeof t);
  float* apf = static_cast<float*>(ap_out);
  float* Bf = static_cast<float*>(B);
  const int blocks = (E + kAffTile - 1) / kAffTile * k;
  cudaError_t err;
  switch (n) {
#define SEM_CASE(NN)                                                         \
  case NN:                                                                   \
    err = curved_smem_attribute<NN>(cg_a_general_kernel<NN, PT>);           \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    cg_a_general_kernel<NN, PT><<<blocks, aff_threads<NN>(),                 \
                                  sizeof(CurvedSmem<NN>), s>>>(              \
        static_cast<const float*>(r), static_cast<const PT*>(p),             \
        static_cast<const PT*>(inv), static_cast<const float*>(x), t,        \
        static_cast<const float*>(gT), static_cast<const float*>(beta),      \
        static_cast<const float*>(alpha_prev), static_cast<PT*>(p_out),      \
        static_cast<float*>(x_out), apf, Bf, static_cast<float*>(dparts), E, \
        nb, k);                                                              \
    break;
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dss_gather(
      Bf, apf, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), n,
      E, nb, k, s));
}

}  // namespace sem

// The size of GeneralTables, for the host side's check of its layout.
extern "C" int sem_general_tables_size() {
  return static_cast<int>(sizeof(sem::GeneralTables));
}

// r, x, x_out, ap_out: (k * n, E) f32; p, p_out: (k * n, E) f32 (_f32) or
// bf16 (_bf16); inv: (n, E) of p's type; tables: host pointer to the
// operator's GeneralTables (sem_curved.cuh); gT: (3, n, E) f32 lex-order
// factor slabs; beta, alpha_prev: (k,) f32 on the device; B: (k, nb, E)
// f32 scratch; dparts: (ceil(E / 32), k) f32, one row per tile of 32
// elements.  Returns a cudaError_t code (0 on success).
#define SEM_CG_A_GENERAL_ENTRY(NAME, PT)                                       \
  extern "C" int NAME(const void* r, const void* p, const void* inv,          \
                      const void* x, const void* tables, const void* gT,      \
                      const void* beta, const void* alpha_prev, void* p_out,  \
                      void* x_out, void* ap_out, void* B, void* dparts,       \
                      const void* row_ptr, const void* entries,               \
                      const void* masks, int n, int E, int nb, int k,         \
                      void* stream) {                                         \
    return sem::cg_kernel_a_general<PT>(                                      \
        r, p, inv, x, tables, gT, beta, alpha_prev, p_out, x_out, ap_out, B,  \
        dparts, row_ptr, entries, masks, n, E, nb, k, stream);                \
  }
SEM_CG_A_GENERAL_ENTRY(sem_cg_kernel_a_general_f32, float)
SEM_CG_A_GENERAL_ENTRY(sem_cg_kernel_a_general_bf16, __nv_bfloat16)
