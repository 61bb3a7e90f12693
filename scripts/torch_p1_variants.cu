// Variants of the p = 1 apply (csrc/sem_p1.cuh), for timing on the card by
// scripts/torch_p1_variants.py; none of them is on the main path.
#include <cooperative_groups.h>
#include <cstring>

#include "../spectralelementmethod_torch/csrc/sem_p1.cuh"

namespace cg = cooperative_groups;

namespace exp1 {
using namespace sem;

template <class Op>
__device__ __forceinline__ void p1_load(const float* __restrict__ u,
                                        const float* __restrict__ coef,
                                        int E, int e, float (&x)[4],
                                        float (&c)[Op::kCoef]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = u[(size_t)j * E + e];
#pragma unroll
  for (int q = 0; q < Op::kCoef; ++q) c[q] = coef[(size_t)q * E + e];
}

struct Flat {
  int n;
  int delta[32];
  unsigned char dst[32];
  unsigned char src[32];
  unsigned short mask[32];
};

// v0: own product only (no DSS): the floor of reading and writing
template <class Op>
__global__ void __launch_bounds__(128)
    own_only(const float* __restrict__ u, const typename Op::Tables t,
             const float* __restrict__ coef, float* __restrict__ out, int E) {
  const int e = blockIdx.x * 128 + threadIdx.x;
  if (e >= E) return;
  u += (size_t)blockIdx.y * 4 * E;
  out += (size_t)blockIdx.y * 4 * E;
  float x[4], c[Op::kCoef], S[4];
  p1_load<Op>(u, coef, E, e, x, c);
  Op::product(t, x, c, S);
#pragma unroll
  for (int d = 0; d < 4; ++d) out[(size_t)d * E + e] = S[d];
}

// v1: serial lazy recompute over a flat entry list
template <class Op>
__global__ void __launch_bounds__(128)
    serial(const float* __restrict__ u, const typename Op::Tables t,
           const float* __restrict__ coef, const bool* __restrict__ masks,
           const Flat cls, float* __restrict__ out, int E) {
  const int e = blockIdx.x * 128 + threadIdx.x;
  if (e >= E) return;
  u += (size_t)blockIdx.y * 4 * E;
  out += (size_t)blockIdx.y * 4 * E;
  float acc[4];
  {
    float x[4], c[Op::kCoef];
    p1_load<Op>(u, coef, E, e, x, c);
    Op::product(t, x, c, acc);
  }
  float Sn[4];
  int have = 0, prev = 0;
  for (int i = 0; i < cls.n; ++i) {
    const int delta = cls.delta[i], s = e + delta;
    if (s < 0 || s >= E || !masks[(size_t)cls.mask[i] * E + e]) continue;
    if (!have || delta != prev) {
      float x[4], c[Op::kCoef];
      p1_load<Op>(u, coef, E, s, x, c);
      Op::product(t, x, c, Sn);
      have = 1;
      prev = delta;
    }
    const int src = cls.src[i], dst = cls.dst[i];
    float v = Sn[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) v = src == j ? Sn[j] : v;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      acc[d] = dst == d ? __fadd_rn(acc[d], v) : acc[d];
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) out[(size_t)d * E + e] = acc[d];
}

// v3: cooperative: products to B, grid barrier, gather from B
template <class Op, int NT>
__global__ void __launch_bounds__(NT)
    coop(const float* __restrict__ u, const typename Op::Tables t,
         const float* __restrict__ coef, const bool* __restrict__ masks,
         const Flat cls, float* __restrict__ out, float* __restrict__ B,
         int E, int k) {
  const int tiles = (E + NT - 1) / NT, items = tiles * k;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int rhs = it % k, e = (it / k) * NT + threadIdx.x;
    if (e >= E) continue;
    float x[4], c[Op::kCoef], S[4];
    p1_load<Op>(u + (size_t)rhs * 4 * E, coef, E, e, x, c);
    Op::product(t, x, c, S);
    float* b = B + (size_t)rhs * 4 * E;
#pragma unroll
    for (int d = 0; d < 4; ++d) b[(size_t)d * E + e] = S[d];
  }
  cg::this_grid().sync();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int rhs = it % k, e = (it / k) * NT + threadIdx.x;
    if (e >= E) continue;
    const float* b = B + (size_t)rhs * 4 * E;
    float acc[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) acc[d] = b[(size_t)d * E + e];
    for (int i0 = 0; i0 < cls.n; i0 += 4) {
      float v[4];
      bool on[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j, s = e + cls.delta[i];
        on[j] = i < cls.n && s >= 0 && s < E
                && masks[(size_t)cls.mask[i] * E + e];
        v[j] = on[j] ? b[(size_t)cls.src[i] * E + s] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + j;
        if (i >= cls.n) break;
        const int dst = cls.dst[i];
        if (on[j]) {
#pragma unroll
          for (int d = 0; d < 4; ++d)
            acc[d] = dst == d ? __fadd_rn(acc[d], v[j]) : acc[d];
        }
      }
    }
    float* o = out + (size_t)rhs * 4 * E;
#pragma unroll
    for (int d = 0; d < 4; ++d) o[(size_t)d * E + e] = acc[d];
  }
}

template <class Op, int NT>
int launch_coop(const void* u, const void* tables, const void* coef,
                const void* masks, const void* flat, void* out, void* B,
                int E, int k, int blocks_per_sm, void* stream) {
  typename Op::Tables t;
  Flat cls;
  std::memcpy(&t, tables, sizeof t);
  std::memcpy(&cls, flat, sizeof cls);
  int dev, nsm, occ;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, coop<Op, NT>, NT, 0);
  if (blocks_per_sm > 0 && blocks_per_sm < occ) occ = blocks_per_sm;
  const int items = ((E + NT - 1) / NT) * k;
  int grid = nsm * occ;
  if (grid > items) grid = items;
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(coef);
  const bool* mf = static_cast<const bool*>(masks);
  float* of = static_cast<float*>(out);
  float* bf = static_cast<float*>(B);
  void* args[] = {&uf, &t, &cf, &mf, &cls, &of, &bf, &E, &k};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)coop<Op, NT>, grid, NT, args, 0,
      static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <class Op>
int launch_other(int which, const void* u, const void* tables,
                 const void* coef, const void* masks, const void* flat,
                 void* out, int E, int k, void* stream) {
  typename Op::Tables t;
  Flat cls;
  std::memcpy(&t, tables, sizeof t);
  std::memcpy(&cls, flat, sizeof cls);
  const dim3 grid((E + 127) / 128, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0)
    own_only<Op><<<grid, 128, 0, s>>>(static_cast<const float*>(u), t,
                                      static_cast<const float*>(coef),
                                      static_cast<float*>(out), E);
  else
    serial<Op><<<grid, 128, 0, s>>>(
        static_cast<const float*>(u), t, static_cast<const float*>(coef),
        static_cast<const bool*>(masks), cls, static_cast<float*>(out), E);
  return (int)cudaGetLastError();
}

}  // namespace exp1

extern "C" int exp_coop(int curved, int nt, const void* u, const void* tables,
                        const void* coef, const void* masks, const void* flat,
                        void* out, void* B, int E, int k, int bps,
                        void* stream) {
  using namespace exp1;
  if (curved)
    return nt == 256 ? launch_coop<GeneralP1, 256>(u, tables, coef, masks,
                                                    flat, out, B, E, k, bps,
                                                    stream)
                     : launch_coop<GeneralP1, 128>(u, tables, coef, masks,
                                                    flat, out, B, E, k, bps,
                                                    stream);
  return nt == 256 ? launch_coop<AffineP1, 256>(u, tables, coef, masks, flat,
                                                 out, B, E, k, bps, stream)
                   : launch_coop<AffineP1, 128>(u, tables, coef, masks, flat,
                                                 out, B, E, k, bps, stream);
}

extern "C" int exp_other(int curved, int which, const void* u,
                         const void* tables, const void* coef,
                         const void* masks, const void* flat, void* out,
                         int E, int k, void* stream) {
  using namespace exp1;
  if (curved)
    return launch_other<GeneralP1>(which, u, tables, coef, masks, flat, out,
                                   E, k, stream);
  return launch_other<AffineP1>(which, u, tables, coef, masks, flat, out, E,
                                k, stream);
}
