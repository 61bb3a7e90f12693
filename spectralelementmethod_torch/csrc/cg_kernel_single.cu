// cg_kernel_single: one whole Jacobi-PCG iteration on transposed (n, E)
// L-vectors (affine meshes), with the residual update deferred into the
// next iteration's kernel:
//
//   r'  = r - alpha_prev * Ap          (Ap: the previous iteration's Ap')
//   p'  = inv * r' + beta * p, stored in p's type (f32 or bf16)
//   Ap' = DSS(sum_c a_c K_c p'_stored)
//   x'  = x + alpha_prev * p           (left out with DEFER)
//   parts[g, :] = partial sums of
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
// MB): bytes.  With x and f32 p, inv, w it moves ten passes (r, Ap, p, x,
// inv, w in; r', p', Ap', x' out), 323.5 MB or 97 us at 3.35 TB/s; with
// bf16 p, inv and w, 258.8 MB (77 us); deferred, 258.8 MB in f32 and 194.1
// MB (58 us) in bf16.  The product in tensor-product form does 0.63 GFLOP
// (9 us at 67 TFLOP/s).
//
// Design: kernel A's (cg_kernel_a.cu) tile of 32 elements and M warps
// around aff_product (sem_affine.cuh).  Warp w's column line (a, w) reads
// r, Ap, p, x, inv and w at rows row[a M + w], forms r', p' and x' (with
// kernel A's explicit roundings, so they match the plain version bit for
// bit) and the pointwise e1 and e2, and hands the stored p' to the
// product.  Its row line (w, c) writes S to B (rows < nb) or to Ap' and
// forms denom from the row-line p' the product returns, as kernel A does;
// Ap' is the apply's product of the stored p', bit for bit.  c1 and c2
// need w inv r' and w inv at the row-line nodes: the column-line owner
// keeps them in registers and writes them into the product's hand-over
// slots that only it reads after the flux (its hook, between the second
// and the third barrier), and the row-line owner reads them after the
// third, so they cost no global read-back and no extra shared memory.  On
// the interior rows [nb, n), whose Ap' is final, that gives c1 and c2;
// the gather launch forms Ap' on the exchanged rows and adds theirs.
// Layout of parts: rows [0, G_tile) one per tile (G_tile = ceil(E / 32)),
// then, when nb > 0, rows [G_tile, G_tile + G_gather) one per gather block
// of 256 elements (G_gather = ceil(E / 256)), with zeros in the other
// columns.  The launch bounds allow 2 blocks (18 warps) per SM: the three
// column-line arrays it keeps through the product need the registers.
#include "sem_affine.cuh"

#include <cstring>

namespace sem {

constexpr int kParts = 5;
constexpr int kSingleMinBlocks = 2;

template <int N, typename PT, bool DEFER>
__global__ void __launch_bounds__(aff_threads<N>(), kSingleMinBlocks)
    cg_single_local_kernel(const float* __restrict__ r,
                           const float* __restrict__ ap,
                           const PT* __restrict__ p,
                           const float* __restrict__ x,
                           const PT* __restrict__ inv,
                           const PT* __restrict__ wt,
                           const AffineTables t,
                           const float* __restrict__ aT,
                           const float* __restrict__ alpha_prev_v,
                           const float* __restrict__ beta_v,
                           float* __restrict__ r_out, PT* __restrict__ p_out,
                           float* __restrict__ ap_out,
                           float* __restrict__ x_out, float* __restrict__ B,
                           float* __restrict__ parts, int E, int nb) {
  constexpr int M = AffSmem<N>::M;
  __shared__ AffSmem<N> sm;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * kAffTile + lane;
  const bool valid = e < E;
  const float alpha_prev = *alpha_prev_v, beta = *beta_v;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  if (valid) {
    a0 = aT[e];
    a1 = aT[E + e];
    a2 = aT[2 * E + e];
  }
  // [denom, c1, c2, e1, e2]
  float sums[kParts] = {0.f, 0.f, 0.f, 0.f, 0.f};
  // the column line (a, w): r', p', x', e1, e2, and w inv r' (q1) and
  // w inv (q2) for the row-line owners
  float xv[M], q1[M], q2[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    xv[a] = q1[a] = q2[a] = 0.f;
    if (valid) {
      const size_t o = (size_t)t.row[a * M + w] * E + e;
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
      xv[a] = to_f32(st);
      const float wv = to_f32(wt[o]);
      const float wr = wv * rv;
      sums[3] = fmaf(wr, iv * rv, sums[3]);
      sums[4] = fmaf(wr, rv, sums[4]);
      q2[a] = wv * iv;
      q1[a] = q2[a] * rv;
    }
  }
  float S[M], y[M];
  // node (a, w)'s q1 into the column-line slot sm.s[a M + w], its q2 into
  // the row-line slot sm.r[w M + a]: no other thread reads either slot
  // between the second and the third barrier
  aff_product<N>(sm, t, xv, a0, a1, a2, S, y, [&](AffSmem<N>& h) {
#pragma unroll
    for (int a = 0; a < M; ++a) {
      h.s[a * M + w][lane] = q1[a];
      h.r[w * M + a][lane] = q2[a];
    }
  });
  // the row line (w, c): node (w, c) is column-line node (w, c) of warp c,
  // whose q1 sits at sm.s[w M + c] and q2 at sm.r[c M + w]
#pragma unroll
  for (int c = 0; c < M; ++c) {
    sums[0] = fmaf(y[c], S[c], sums[0]);
    if (valid) {
      const int j = t.row[w * M + c];
      if (j < nb) {
        B[(size_t)j * E + e] = S[c];
      } else {
        ap_out[(size_t)j * E + e] = S[c];
        sums[1] = fmaf(sm.s[w * M + c][lane], S[c], sums[1]);
        sums[2] = fmaf(sm.r[c * M + w][lane] * S[c], S[c], sums[2]);
      }
    }
  }
  block_sums(sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int c = 0; c < kParts; ++c)
      parts[(size_t)blockIdx.x * kParts + c] = sums[c];
  }
}

// Ap'[d, e] = the DSS of the exchanged row d < nb, and block g's c1 and c2
// over those rows into row g_tile + g of parts.
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
                            float* __restrict__ parts, int E, int nb,
                            int g_tile) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float c[2] = {0.f, 0.f};
  if (e < E) {
    for (int d = 0; d < nb; ++d) {
      const float s = dss_gather_row(B, row_ptr, ent, masks, E, d, e);
      const size_t o = (size_t)d * E + e;
      ap_out[o] = s;
      const float q = to_f32(inv[o]) * s;
      const float wv = to_f32(w[o]);
      c[0] = fmaf(wv * r_out[o], q, c[0]);
      c[1] = fmaf(wv * s, q, c[1]);
    }
  }
  block_sums(c);
  if (threadIdx.x == 0) {
    float* row = parts + (size_t)(g_tile + blockIdx.x) * kParts;
    row[0] = 0.f;
    row[1] = c[0];
    row[2] = c[1];
    row[3] = 0.f;
    row[4] = 0.f;
  }
}

template <int N, typename PT, bool DEFER>
cudaError_t launch_single_local(const float* r, const float* ap, const PT* p,
                                const float* x, const PT* inv, const PT* w,
                                const AffineTables& t, const float* aT,
                                const float* alpha_prev, const float* beta,
                                float* r_out, PT* p_out, float* ap_out,
                                float* x_out, float* B, float* parts, int E,
                                int nb, cudaStream_t stream) {
  const int tiles = (E + kAffTile - 1) / kAffTile;
  cg_single_local_kernel<N, PT, DEFER>
      <<<tiles, aff_threads<N>(), 0, stream>>>(
          r, ap, p, x, inv, w, t, aT, alpha_prev, beta, r_out, p_out, ap_out,
          x_out, B, parts, E, nb);
  return cudaGetLastError();
}

template <typename PT, bool DEFER>
int cg_kernel_single(const void* r, const void* ap, const void* p,
                     const void* x, const void* inv, const void* w,
                     const void* tables, const void* aT,
                     const void* alpha_prev, const void* beta, void* r_out,
                     void* p_out, void* ap_out, void* x_out, void* B,
                     void* parts, const void* row_ptr, const void* entries,
                     const void* masks, int n, int E, int nb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AffineTables t;
  std::memcpy(&t, tables, sizeof t);
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
        t, static_cast<const float*>(aT),                                   \
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
  const int g_tile = (E + kAffTile - 1) / kAffTile;
  const int grid = (E + kThreads - 1) / kThreads;
  cg_single_gather_kernel<PT><<<grid, kThreads, 0, s>>>(
      Bf, apf, rf, invp, wp, static_cast<const int*>(row_ptr),
      static_cast<const int4*>(entries), static_cast<const bool*>(masks), pf,
      E, nb, g_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sem

// r, ap, x, r_out, ap_out, x_out: (n, E) f32; p, inv, w, p_out: (n, E) f32
// (_f32) or bf16 (_bf16); tables: host pointer to the operator's
// AffineTables (sem_affine.cuh); aT: (3, E) f32; alpha_prev, beta: f32
// scalars on the device; B: (nb, E) f32 scratch; parts: (G_tile +
// G_gather, 5) f32 with G_tile = ceil(E / 32) rows of the product tiles
// and G_gather = ceil(E / 256) rows of the gather blocks (c1 and c2 of the
// exchanged rows; zeros elsewhere), or (G_tile, 5) when nb = 0.  Returns a
// cudaError_t code (0 on success).
#define SEM_SINGLE_ENTRY(NAME, PT)                                            \
  extern "C" int NAME(const void* r, const void* ap, const void* p,          \
                      const void* x, const void* inv, const void* w,         \
                      const void* tables, const void* aT,                    \
                      const void* alpha_prev, const void* beta, void* r_out, \
                      void* p_out, void* ap_out, void* x_out, void* B,       \
                      void* parts, const void* row_ptr, const void* entries, \
                      const void* masks, int n, int E, int nb,               \
                      void* stream) {                                        \
    return sem::cg_kernel_single<PT, false>(                                 \
        r, ap, p, x, inv, w, tables, aT, alpha_prev, beta, r_out, p_out,     \
        ap_out, x_out, B, parts, row_ptr, entries, masks, n, E, nb, stream); \
  }
SEM_SINGLE_ENTRY(sem_cg_kernel_single_f32, float)
SEM_SINGLE_ENTRY(sem_cg_kernel_single_bf16, __nv_bfloat16)

// The deferred kernel: as above without x and x_out.
#define SEM_SINGLE_DEFER_ENTRY(NAME, PT)                                      \
  extern "C" int NAME(const void* r, const void* ap, const void* p,          \
                      const void* inv, const void* w, const void* tables,    \
                      const void* aT, const void* alpha_prev,                \
                      const void* beta, void* r_out, void* p_out,            \
                      void* ap_out, void* B, void* parts,                    \
                      const void* row_ptr, const void* entries,              \
                      const void* masks, int n, int E, int nb,               \
                      void* stream) {                                        \
    return sem::cg_kernel_single<PT, true>(                                  \
        r, ap, p, nullptr, inv, w, tables, aT, alpha_prev, beta, r_out,      \
        p_out, ap_out, nullptr, B, parts, row_ptr, entries, masks, n, E, nb, \
        stream);                                                             \
  }
SEM_SINGLE_DEFER_ENTRY(sem_cg_kernel_single_defer_f32, float)
SEM_SINGLE_DEFER_ENTRY(sem_cg_kernel_single_defer_bf16, __nv_bfloat16)

// The size of AffineTables, for the host side's check of its layout.
extern "C" int sem_affine_tables_size() {
  return static_cast<int>(sizeof(sem::AffineTables));
}
