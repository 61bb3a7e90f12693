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
//
// Far mode (cg_b_far_kernel): the same pass on a split DSS, where kernel A
// gathered the near roll classes only and left every exchanged row of its
// product in its (k, nb, E) scratch B.  While it streams Ap, the kernel
// adds each far class's masked, rolled source rows of B into the far
// destination rows, then forms r' and the two partials from that
// corrected Ap, which is never written.  Replaces add_far in kernel_b of
// _build_cg_kernel_b (pallas_kernels.py:1563-1565, add_far :738) and of
// _build_cg_kernel_b_batched (:2218), with make_fused_cg_kernels'
// cheap_far prep (:1411; kernel A's far rows :1473, :1539), the general
// one's (:1889, :1982-1985) and the batched one's (:2054,
// _far_rows_batched :2180).  The far entries come by value (FarB: the
// plan's FarTables, sem_far.cuh, and each row's slot in them); each row's
// entries are added in class order as select(mask && in range, B, 0), the
// far update's sequence of adds, so r' equals far_update then kernel B bit
// for bit (the reference adds one compact far block per destination row,
// in another order).  What bounds it on an H100 (p = 8, E = 99,856,
// max_halo = 128: 22 far entries into 18 rows): the no-far passes plus the
// far source rows (per RHS) and class masks (once), 8 MB more per RHS,
// 0.051 ms against the no-far 0.048 at 3.35 TB/s; the adds are far below
// the card's rate.  A thread loads each entry's mask byte and source value
// independently (the index clamped), as the far update does, and keeps
// the (row, element) of its entry, stepping both by the grid stride, so
// the loop divides nothing; only rows below the last far destination look
// up their slot.
// No TPU mechanism is carried over: no compact far-row block, no sublane
// concat of slots.
#include <cstring>

#include "sem_far.cuh"
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

// Destination row -> its row in FarTables (-1: no far entry), and one past
// the last destination row: the far mode's by-value operand.
struct FarB {
  FarTables t;
  int rows_end;
  signed char slot[256];
};

// One pass of cg_b_kernel on (n, E) blocks of k RHS whose Ap lacks the far
// classes: aux the (k, nb, E) raw exchanged rows of the product, masks the
// plan's (C, E) class masks.
template <typename WT>
__global__ void __launch_bounds__(kThreads)
    cg_b_far_kernel(const float* __restrict__ r, const float* __restrict__ ap,
                    const float* __restrict__ aux,
                    const bool* __restrict__ masks, const FarB f,
                    const WT* __restrict__ inv, const WT* __restrict__ w,
                    const float* __restrict__ alpha_v,
                    float* __restrict__ r_out, float* __restrict__ parts,
                    int E, int n, int nb) {
  const int rhs = blockIdx.y, k = gridDim.y;
  const size_t per = (size_t)n * E;
  const size_t off = (size_t)rhs * per;
  r += off;
  ap += off;
  r_out += off;
  aux += (size_t)rhs * nb * E;
  const float alpha = alpha_v[rhs];
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const int ds = (int)(stride / E), es = (int)(stride % E);
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  int d = (int)(i / E), e = (int)(i % E);
  float rz = 0.f, rn = 0.f;
  for (; i < per; i += stride) {
    float a = ap[i];
    const int sl = d < f.rows_end ? f.slot[d] : -1;
    if (sl >= 0) {
      const int q1 = f.t.first[sl + 1];
      for (int q = f.t.first[sl]; q < q1; ++q) {
        // the mask and the source value are loaded independently (the
        // source index clamped into [0, E)), so neither waits on the other
        const int s = e + f.t.delta[q];
        const bool mk = masks[(size_t)f.t.mask[q] * E + e];
        const float v = aux[(size_t)f.t.src[q] * E + min(max(s, 0), E - 1)];
        a = __fadd_rn(a, mk && s >= 0 && s < E ? v : 0.f);
      }
    }
    const float rv = __fsub_rn(r[i], __fmul_rn(alpha, a));
    r_out[i] = rv;
    const float wr = to_f32(w[i]) * rv;
    rz = fmaf(wr, to_f32(inv[i]) * rv, rz);
    rn = fmaf(wr, rv, rn);
    e += es;
    d += ds;
    if (e >= E) {
      e -= E;
      ++d;
    }
  }
  rz = block_sum(rz);
  rn = block_sum(rn);
  if (threadIdx.x == 0) {
    parts[(size_t)blockIdx.x * k + rhs] = rz;
    parts[(size_t)(gridDim.x + blockIdx.x) * k + rhs] = rn;
  }
}

template <typename WT>
int cg_kernel_b_far(const void* r, const void* ap, const void* aux,
                    const void* masks, const void* tables, const void* inv,
                    const void* w, const void* alpha, void* r_out,
                    void* parts, int E, int n, int nb, int blocks, int k,
                    void* stream) {
  FarB f;
  std::memcpy(&f.t, tables, sizeof f.t);
  if (f.t.n_rows < 0 || f.t.n_rows > kFarMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  std::memset(f.slot, -1, sizeof f.slot);
  f.rows_end = 0;
  for (int q = 0; q < f.t.n_rows; ++q) {
    f.slot[f.t.dst[q]] = static_cast<signed char>(q);
    f.rows_end = f.t.dst[q] + 1 > f.rows_end ? f.t.dst[q] + 1 : f.rows_end;
  }
  for (int q = 0; q < f.t.first[f.t.n_rows]; ++q)
    if (f.t.src[q] >= nb) return static_cast<int>(cudaErrorInvalidValue);
  if (f.rows_end > nb || E <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cg_b_far_kernel<WT><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(ap),
      static_cast<const float*>(aux), static_cast<const bool*>(masks), f,
      static_cast<const WT*>(inv), static_cast<const WT*>(w),
      static_cast<const float*>(alpha), static_cast<float*>(r_out),
      static_cast<float*>(parts), E, n, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sem

// The size of FarTables, for the host side's check of its layout.
extern "C" int sem_far_tables_size() {
  return static_cast<int>(sizeof(sem::FarTables));
}

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

// Far mode: r, ap, r_out: (k n, E) f32; aux: (k, nb, E) f32, the raw
// exchanged rows kernel A left; masks: (C, E) bool, the plan's; tables:
// host pointer to the far plan's FarTables; inv, w, alpha, parts, blocks
// as above.  Returns a cudaError_t code (0 on success).
#define SEM_CG_B_FAR_ENTRY(NAME, WT)                                        \
  extern "C" int NAME(const void* r, const void* ap, const void* aux,      \
                      const void* masks, const void* tables,               \
                      const void* inv, const void* w, const void* alpha,   \
                      void* r_out, void* parts, int E, int n, int nb,      \
                      int blocks, int k, void* stream) {                   \
    return sem::cg_kernel_b_far<WT>(r, ap, aux, masks, tables, inv, w,     \
                                    alpha, r_out, parts, E, n, nb, blocks, \
                                    k, stream);                            \
  }
SEM_CG_B_FAR_ENTRY(sem_cg_kernel_b_far_f32, float)
SEM_CG_B_FAR_ENTRY(sem_cg_kernel_b_far_bf16, __nv_bfloat16)
