// far_update: add the far roll classes of a split DSS into the exchanged
// rows of an apply's output, in place: out[d, e] += mask_c(e) *
// aux[src, e + delta] for every far entry (src, delta, c) of row d.  aux is
// the (nb, E) f32 scratch of raw exchanged rows the apply wrote (its B).
//
// Replaces the TPU kernel make_far_update_kernel
// (spectralelementmethod_tpu/ops/pallas_kernels.py:876; update at :967,
// pallas_call at :970), the far-class epilogue of the single-RHS affine
// and general applies when max_halo splits the classes.
//
// What bounds it on an H100 (p = 8, E = 99,856 with max_halo = 128: 14 edge
// rows and 4 vertex rows take 22 far entries): it reads and writes the 18
// destination rows, reads 22 source values and 22 mask bytes per element,
// 25 MB, 7.6 us at 3.35 TB/s, against 22 adds per element: bound by bytes.
//
// Design: one thread per element; the rows with no far entry are skipped
// (their row_ptr range is empty), so only the destination rows are read
// and written.  Each row's sum starts from out[d, e] and adds the entries in
// class order, as the plain version's per-class adds do, so the two agree
// bit for bit.  No TPU mechanism is carried over: no aliased row grid
// padded to the 8-row sublane tile, no aux halo windows, no procedural
// masks.
#include "sem_kernels.cuh"

namespace sem {

__global__ void __launch_bounds__(kThreads)
    far_update_kernel(float* __restrict__ out, const float* __restrict__ aux,
                      const int* __restrict__ row_ptr,
                      const int4* __restrict__ ent,
                      const bool* __restrict__ masks, int E, int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  for (int d = 0; d < nb; ++d) {
    const int t0 = row_ptr[d], t1 = row_ptr[d + 1];
    if (t0 == t1) continue;
    float acc = out[(size_t)d * E + e];
    for (int t = t0; t < t1; ++t) {
      const int4 q = ent[t];
      const int s = e + q.y;
      if (masks[(size_t)q.z * E + e] && s >= 0 && s < E)
        acc += aux[(size_t)q.x * E + s];
    }
    out[(size_t)d * E + e] = acc;
  }
}

}  // namespace sem

// out: (n, E) f32, updated in place; aux: (nb, E) f32; row_ptr: (nb + 1,)
// int32; entries: (T, 4) int32 (src_row, delta, mask_index, dst_row);
// masks: (C, E) bool.  Returns a cudaError_t code (0 on success).
extern "C" int sem_far_update(void* out, const void* aux, const void* row_ptr,
                              const void* entries, const void* masks, int E,
                              int nb, void* stream) {
  if (nb == 0 || E == 0) return 0;
  const int grid = (E + sem::kThreads - 1) / sem::kThreads;
  sem::far_update_kernel<<<grid, sem::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(aux),
      static_cast<const int*>(row_ptr), static_cast<const int4*>(entries),
      static_cast<const bool*>(masks), E, nb);
  return static_cast<int>(cudaGetLastError());
}
