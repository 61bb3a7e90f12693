// Shared device code of the spectral-element CUDA kernels (sm_90a).
//
// Storage: transposed L-vectors, row-major (n, E) — row j holds local node j
// of every element, so element e of row j sits at j * E + e and a warp of
// consecutive elements reads 32 consecutive words of one row.
//
// The element-local products live in sem_affine.cuh (affine meshes: the
// tensor-product tile of 32 elements and one warp per grid line) and
// sem_curved.cuh (curved meshes, the same tile, which the row-major (E, n)
// element-local kernel, laplacian_local.cu, runs too); no kernel at
// p >= 2 reads an assembled stiffness block.  The direct stiffness
// summation (DSS) is a second pass, dss_gather_kernel: the product kernels
// write the exchanged rows [0, nb) of S to a scratch array B, and the
// gather sums them per roll class from B[src, e + delta] under the class
// mask.  Masks are false wherever
// e + delta leaves [0, E), and the read is guarded by the range as well.
// At p = 1 (n = 4) the apply kernels take one launch instead, product and
// DSS together, from the assembled blocks or Dh by value (sem_p1.cuh).
//
// A stack of k right-hand sides is k (n, E) arrays one after the other,
// (k * n, E); every kernel takes the RHS from blockIdx.y, so the k RHS
// share the operator, the affine scales and the class tables, and k = 1 is
// the single array.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sem {

// A function attribute (the dynamic shared memory limit) belongs to the
// kernel on one device, so a process that drives several cards sets it on
// each: ``once(set)`` runs ``set`` the first time it is called with a
// device current and returns that result there after.  One static object
// per kernel variant; two host threads setting it twice is harmless.
struct OncePerDevice {
  static constexpr int kMaxDevices = 64;
  bool done[kMaxDevices];
  cudaError_t err[kMaxDevices];

  template <typename Set>
  cudaError_t operator()(Set set) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!done[dev]) {
      err[dev] = set();
      done[dev] = true;
    }
    return err[dev];
  }
};

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum over the block; the result is valid in thread 0.  Safe to call
// several times in a row (the leading barrier protects the scratch).
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? warp_sums[threadIdx.x] : 0.f;
  if (wid == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// block_sum of NV values at once, with one pair of barriers: on return
// v[i] holds the block's sum of v[i] in thread 0.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV]) {
  __shared__ float warp_sums[NV][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) warp_sums[i][wid] = v[i];
  }
  __syncthreads();
  if (wid == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      v[i] = lane < (blockDim.x >> 5) ? warp_sums[i][lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[i] += __shfl_down_sync(0xffffffffu, v[i], o);
    }
  }
}

// Row d < nb of the DSS at element e: B[d, e] + the sum over the entries t
// of row d (row_ptr[d] .. row_ptr[d + 1]) of mask[t.z, e] * B[t.x, e + t.y],
// B an (nb, E) scratch block.  Entries are int4 (src_row, delta,
// mask_index, dst_row).
__device__ __forceinline__ float dss_gather_row(
    const float* __restrict__ B, const int* __restrict__ row_ptr,
    const int4* __restrict__ ent, const bool* __restrict__ masks, int E,
    int d, int e) {
  float acc = B[(size_t)d * E + e];
  const int t1 = row_ptr[d + 1];
  for (int t = row_ptr[d]; t < t1; ++t) {
    const int4 q = ent[t];
    const int s = e + q.y;
    if (masks[(size_t)q.z * E + e] && s >= 0 && s < E)
      acc += B[(size_t)q.x * E + s];
  }
  return acc;
}

// out[d, e] = dss_gather_row(d, e) for d < nb, for the RHS blockIdx.y: B is
// its (nb, E) scratch block of a (k, nb, E) stack and out its (n, E) block
// of a (k * n, E) stack.
__global__ void __launch_bounds__(kThreads)
    dss_gather_kernel(const float* __restrict__ B, float* __restrict__ out,
                      const int* __restrict__ row_ptr,
                      const int4* __restrict__ ent,
                      const bool* __restrict__ masks, int n, int E, int nb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  B += (size_t)blockIdx.y * nb * E;
  out += (size_t)blockIdx.y * n * E;
  for (int d = 0; d < nb; ++d)
    out[(size_t)d * E + e] = dss_gather_row(B, row_ptr, ent, masks, E, d, e);
}

inline cudaError_t launch_dss_gather(const float* B, float* out,
                                     const int* row_ptr, const int4* ent,
                                     const bool* masks, int n, int E, int nb,
                                     int k, cudaStream_t stream) {
  if (nb == 0) return cudaSuccess;
  const dim3 grid((E + kThreads - 1) / kThreads, k);
  dss_gather_kernel<<<grid, kThreads, 0, stream>>>(B, out, row_ptr, ent,
                                                    masks, n, E, nb);
  return cudaGetLastError();
}

}  // namespace sem

// Element counts n = (p + 1)^2 with a compiled instantiation of the
// tensor-product tile (p = 2 .. 8); the apply kernels' p = 1 (n = 4) is
// sem_p1.cuh's one-launch form.
#define SEM_FOR_EACH_N(X) X(9) X(16) X(25) X(36) X(49) X(64) X(81)
extern "C" const char* sem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
