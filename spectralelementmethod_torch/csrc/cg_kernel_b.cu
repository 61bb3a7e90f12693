// cg_kernel_b: the residual half of one fused Jacobi-PCG iteration on
// transposed (n, E) L-vectors:
//
//   r' = r - alpha * Ap
//   rz[g] = sum over block g of w * r' * (inv * r')
//   rn[g] = sum over block g of w * r' * r'
//
// with z = inv * r' never stored.  Replaces the TPU kernel_b of
// _build_cg_kernel_b (spectralelementmethod_tpu/ops/pallas_kernels.py:1548,
// pallas_call at :1596).  inv and w are the masked inverse diagonal and the
// inverse-multiplicity weights zeroed on Dirichlet rows, f32 or (bf16 mode)
// bf16; r and Ap stay f32.
//
// What bounds it on an H100 (p = 8, E = 99,856): five (n, E) passes (r, Ap,
// inv, w in; r' out), 162 MB or 48 us at 3.35 TB/s (129 MB, 39 us with bf16
// inv and w); its 7 flops per entry are far below the card's rate: bound by
// bytes.
//
// Design: one elementwise pass with two reductions, written in CUDA C++ in
// the same library scheme as the other two kernels.  A grid-stride loop
// over the n * E entries, a grid of 4 blocks per SM (the wrapper reads the
// card's SM count and passes the block count), one pair of partial sums per
// block; the CG loop sums the partials.
#include "sem_kernels.cuh"

namespace sem {

template <typename WT>
__global__ void __launch_bounds__(kThreads)
    cg_b_kernel(const float* __restrict__ r, const float* __restrict__ ap,
                const WT* __restrict__ inv, const WT* __restrict__ w,
                const float* __restrict__ alpha_p, float* __restrict__ r_out,
                float* __restrict__ parts, size_t total) {
  const float alpha = *alpha_p;
  float rz = 0.f, rn = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
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
    parts[blockIdx.x] = rz;
    parts[gridDim.x + blockIdx.x] = rn;
  }
}

template <typename WT>
int cg_kernel_b(const void* r, const void* ap, const void* inv, const void* w,
                const void* alpha, void* r_out, void* parts, long long total,
                int blocks, void* stream) {
  cg_b_kernel<WT><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(ap),
      static_cast<const WT*>(inv), static_cast<const WT*>(w),
      static_cast<const float*>(alpha), static_cast<float*>(r_out),
      static_cast<float*>(parts), static_cast<size_t>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sem

// r, ap, r_out: n * E f32; inv, w: n * E f32 (_f32) or bf16 (_bf16);
// alpha: f32 scalar on the device; parts: (2, blocks) f32 — row 0 the
// <w r', inv r'> partials, row 1 the <w r', r'> partials; blocks: the
// grid size.  Returns a cudaError_t code (0 on success).
#define SEM_CG_B_ENTRY(NAME, WT)                                            \
  extern "C" int NAME(const void* r, const void* ap, const void* inv,      \
                      const void* w, const void* alpha, void* r_out,       \
                      void* parts, long long total, int blocks,            \
                      void* stream) {                                      \
    return sem::cg_kernel_b<WT>(r, ap, inv, w, alpha, r_out, parts, total,  \
                                blocks, stream);                            \
  }
SEM_CG_B_ENTRY(sem_cg_kernel_b_f32, float)
SEM_CG_B_ENTRY(sem_cg_kernel_b_bf16, __nv_bfloat16)
