// cg_kernel_b: the residual half of one fused Jacobi-PCG iteration on
// transposed (n, E) L-vectors, for one right-hand side or a (k * n, E)
// stack of k that share the preconditioner and the dot weights:
//
//   r' = r - alpha * Ap
//   rz[g, j] = sum over block g of w * r' * (inv * r')
//   rn[g, j] = sum over block g of w * r' * r'
//
// per RHS j, with alpha a (k,) vector on the device and z = inv * r' never
// stored.  Replaces the TPU kernel_b of _build_cg_kernel_b
// (spectralelementmethod_tpu/ops/pallas_kernels.py:1548, pallas_call at
// :1596) and of _build_cg_kernel_b_batched (:2189, pallas_call :2245).  inv
// and w are the masked inverse diagonal and the inverse-multiplicity weights
// zeroed on Dirichlet rows, (n, E) f32 or (bf16 mode) bf16; r and Ap stay
// f32.
//
// What bounds it on an H100 (p = 8, E = 99,856): five (n, E) passes (r, Ap,
// inv, w in; r' out), 162 MB or 48 us at 3.35 TB/s (129 MB, 39 us with bf16
// inv and w); its 7 flops per entry are far below the card's rate: bound by
// bytes.  A k-stack reads inv and w once: at k = 4, 453 MB (0.135 ms) f32
// and 421 MB (0.126 ms) bf16.
//
// Design: one elementwise pass with two reductions, written in CUDA C++ in
// the same library scheme as the other kernels.  A grid-stride loop over the
// n * E entries of one RHS, the RHS in blockIdx.y, about 4 blocks per SM in
// all (the wrapper reads the card's SM count and passes the block count per
// RHS), one pair of partial sums per block and RHS; the CG loop sums them.
#include "sem_kernels.cuh"

namespace sem {

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    cg_b_kernel(const float* __restrict__ r, const float* __restrict__ ap,
                const WT* __restrict__ inv, const WT* __restrict__ w,
                const float* __restrict__ alpha_v, float* __restrict__ r_out,
                float* __restrict__ parts, size_t per) {
  const int rhs = blockIdx.y, k = gridDim.y;
  const size_t off = (size_t)rhs * per;
  r += off;
  ap += off;
  r_out += off;
  const float alpha = alpha_v[rhs];
  float rz = 0.f, rn = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (size_t)gridDim.x * blockDim.x) {
    const float rv = __fsub_rn(r[i], __fmul_rn(alpha, ap[i]));
    r_out[i] = rv;
    const float wr = to_f32(w[i]) * rv;
    rz = fmaf(wr, to_f32(inv[i]) * rv, rz);
    rn = fmaf(wr, rv, rn);
  }
  rz = block_sum(rz);
  rn = block_sum(rn);
  if (threadIdx.x == 0) {
    parts[(size_t)blockIdx.x * k + rhs] = rz;
    parts[(size_t)(gridDim.x + blockIdx.x) * k + rhs] = rn;
  }
}

template <typename WT>
int cg_kernel_b(const void* r, const void* ap, const void* inv, const void* w,
                const void* alpha, void* r_out, void* parts, long long per,
                int blocks, int k, void* stream) {
  const dim3 grid(blocks, k);
  cg_b_kernel<WT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(ap),
      static_cast<const WT*>(inv), static_cast<const WT*>(w),
      static_cast<const float*>(alpha), static_cast<float*>(r_out),
      static_cast<float*>(parts), static_cast<size_t>(per));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sem

// r, ap, r_out: k * per f32; inv, w: per f32 (_f32) or bf16 (_bf16); alpha:
// (k,) f32 on the device; parts: (2, blocks, k) f32 — [0] the <w r', inv r'>
// partials, [1] the <w r', r'> partials; blocks: the grid's size per RHS.
// Returns a cudaError_t code (0 on success).
#define SEM_CG_B_ENTRY(NAME, WT)                                            \
  extern "C" int NAME(const void* r, const void* ap, const void* inv,      \
                      const void* w, const void* alpha, void* r_out,       \
                      void* parts, long long per, int blocks, int k,       \
                      void* stream) {                                      \
    return sem::cg_kernel_b<WT>(r, ap, inv, w, alpha, r_out, parts, per,    \
                                blocks, k, stream);                         \
  }
SEM_CG_B_ENTRY(sem_cg_kernel_b_f32, float)
SEM_CG_B_ENTRY(sem_cg_kernel_b_bf16, __nv_bfloat16)
