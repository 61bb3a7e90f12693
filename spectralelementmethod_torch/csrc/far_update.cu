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
// Design: the plan's far entries come by value in FarTables, a kernel
// parameter in the constant bank that the host builds once per far plan
// (ops/kernels.py far_tables), so the loop reads no entry from device
// memory.  The grid spreads over (destination row, 4-element group):
// blockIdx.y picks the row, each thread takes 4 consecutive elements, so
// 18 rows of E / 4 threads fill the card.  A thread's loads are all
// independent and issued together: its 4 outputs (one 16-byte load), and
// per entry one 4-byte word of mask bytes and the 4 source values, at a
// source index clamped into [0, E) so that no load waits on a branch.  Each
// sum starts from out[d, e] and adds the entries in class order, each as
// select(mask && in range, aux, 0), which is the plain version's sequence
// of adds (roll_dss_T's per-class where and add), so the two agree bit for
// bit.  Unaligned rows (E not a multiple of 4) take the same path with
// 4-byte loads.  No TPU mechanism is carried over: no aliased row grid
// padded to the 8-row sublane tile, no aux halo windows, no procedural
// masks.
#include <cstring>

#include "sem_kernels.cuh"

namespace sem {

// the most far entries (and destination rows) a plan may have
constexpr int kFarMaxEntries = 128;
// elements per thread
constexpr int kFarVec = 4;

// The by-value operand: the destination rows with far entries, and their
// entries in class order (row r's are first[r] .. first[r + 1]).
struct FarTables {
  int n_rows;
  unsigned char dst[kFarMaxEntries];        // row r's destination row
  unsigned char first[kFarMaxEntries + 1];  // row r's first entry
  unsigned char src[kFarMaxEntries];        // entry's source row
  unsigned char mask[kFarMaxEntries];       // entry's class mask
  int delta[kFarMaxEntries];                // entry's element offset
};

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    far_update_kernel(float* __restrict__ out, const float* __restrict__ aux,
                      const bool* __restrict__ masks, const FarTables t,
                      int E) {
  const int r = blockIdx.y;
  const int e = kFarVec * (blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= E) return;
  float* o = out + (size_t)t.dst[r] * E + e;
  float acc[kFarVec];
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(o);
    acc[0] = v.x, acc[1] = v.y, acc[2] = v.z, acc[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kFarVec; ++i) acc[i] = e + i < E ? o[i] : 0.f;
  }
  const int q1 = t.first[r + 1];
#pragma unroll 2
  for (int q = t.first[r]; q < q1; ++q) {
    const bool* mk = masks + (size_t)t.mask[q] * E + e;
    const float* a = aux + (size_t)t.src[q] * E;
    const int s = e + t.delta[q];
    unsigned mw;
    if constexpr (VEC) {
      mw = *reinterpret_cast<const unsigned*>(mk);
    } else {
      mw = 0;
#pragma unroll
      for (int i = 0; i < kFarVec; ++i)
        if (e + i < E) mw |= (unsigned)mk[i] << (8 * i);
    }
    float v[kFarVec];
#pragma unroll
    for (int i = 0; i < kFarVec; ++i) v[i] = a[min(max(s + i, 0), E - 1)];
#pragma unroll
    for (int i = 0; i < kFarVec; ++i) {
      const bool on = ((mw >> (8 * i)) & 0xffu) && s + i >= 0 && s + i < E;
      acc[i] = __fadd_rn(acc[i], on ? v[i] : 0.f);
    }
  }
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kFarVec; ++i)
      if (e + i < E) o[i] = acc[i];
  }
}

}  // namespace sem

// The size of FarTables, for the host side's check of its layout.
extern "C" int sem_far_tables_size() {
  return static_cast<int>(sizeof(sem::FarTables));
}

// out: (n, E) f32, updated in place; aux: (nb, E) f32; masks: (C, E) bool;
// tables: host pointer to the far plan's FarTables (copied here, then
// passed by value).  Rows are read and written with 16-byte accesses when
// E is a multiple of 4 and out and masks are aligned.  Returns a
// cudaError_t code (0 on success).
extern "C" int sem_far_update(void* out, const void* aux, const void* masks,
                              const void* tables, int E, void* stream) {
  sem::FarTables t;
  std::memcpy(&t, tables, sizeof t);
  if (t.n_rows == 0 || E == 0) return 0;
  if (t.n_rows < 0 || t.n_rows > sem::kFarMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((E + sem::kFarVec * sem::kThreads - 1) /
                      (sem::kFarVec * sem::kThreads),
                  t.n_rows);
  const bool vec = E % sem::kFarVec == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(masks) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* of = static_cast<float*>(out);
  const float* af = static_cast<const float*>(aux);
  const bool* mf = static_cast<const bool*>(masks);
  if (vec)
    sem::far_update_kernel<true><<<grid, sem::kThreads, 0, s>>>(of, af, mf,
                                                                 t, E);
  else
    sem::far_update_kernel<false><<<grid, sem::kThreads, 0, s>>>(of, af, mf,
                                                                  t, E);
  return static_cast<int>(cudaGetLastError());
}
