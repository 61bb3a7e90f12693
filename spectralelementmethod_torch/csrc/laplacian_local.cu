// laplacian_local: the element-local weak Laplacian on row-major (E, n) f32
// L-vectors, without DSS,
//
//   [ur us] = u Dh^T,   [fr fs] = [g0 ur + g1 us, g1 ur + g2 us],
//   out = [fr fs] Dh,
//
// for one array, for k arrays stacked as (k, E, n), or for k components
// packed side by side as (E, k n): the kernel takes an element stride es and
// a component stride cs (in floats), and component c of element e starts at
// e * es + c * cs.  The factors g (3, E, n) and Dh are shared by the k.
//
// Replaces the TPU kernels fused_laplacian_local
// (spectralelementmethod_tpu/ops/pallas_kernels.py:76, pallas_call at :111)
// and fused_vector_laplacian_local (:149, pallas_call at :169): the local
// apply of the reference's "en"-layout operator with backend="pallas"
// (ops/sumfac.py:536-546), which the Helmholtz solve_local runs.
//
// What bounds it on an H100 (p = 8, n = 81, E = 99,856): it must read u and
// the three factor arrays and write out, 20 B per node or 162 MB, 48 us at
// 3.35 TB/s, against 8 n M + 6 n = 6,318 flops per element in
// tensor-product form (0.63 GFLOP, 9 us at 67 TFLOP/s): bound by bytes.
// k arrays or components read the factors once through L2: 8 k + 12 B per
// node.
//
// Design: a block takes a tile of kGenTile = 32 elements of one component
// (block b: tile b / k, component b % k, so the k blocks of a tile run
// together and share its factors through L2).  The tile's u, its three
// factor arrays and its output are each 32 rows of n contiguous floats in
// global memory: the block stages them through shared memory with
// consecutive threads on consecutive addresses, u into lex slots, g0 and g1
// into the flux slots they become (gen_flux_by reads a node's factors before
// it writes its flux) and g2 beside them.  The derivative products run in
// tensor-product form from sem_general.cuh (gen_flux_by, gen_row), one lane
// per element, the output rows are staged back into the tile's u array and
// stored row-major.  Rows of shared memory are padded to 33 floats, so that
// the element-by-element staging hits 32 distinct banks.  No TPU mechanism is
// carried over: the FMAs are true f32.
#include "sem_general.cuh"

namespace sem {

constexpr int kLocalPitch = kGenTile + 1;

// The factors of this lane's element as staged in shared memory: g0 and g1
// in the flux slots, g2 in its own array.
template <int N>
struct StagedFactors {
  const GenSmem<N, kLocalPitch>& s;
  const float (*g2)[kLocalPitch];
  int lane;
  __device__ __forceinline__ float operator()(int c, int q) const {
    return c == 0 ? s.f[q][lane] : c == 1 ? s.f[N + q][lane] : g2[q][lane];
  }
};

template <int N>
__global__ void __launch_bounds__(kGenThreads)
    laplacian_local_kernel(const float* __restrict__ u,
                           const float* __restrict__ g,
                           const float* __restrict__ Dh,
                           const int* __restrict__ hier,
                           float* __restrict__ out, int E, int k,
                           long long es, long long cs) {
  __shared__ GenSmem<N, kLocalPitch> s;
  __shared__ float g2[N][kLocalPitch];
  gen_load_tables(s, Dh, hier);
  const int tile = blockIdx.x / k, comp = blockIdx.x % k;
  const int e0 = tile * kGenTile;
  const int ne = min(kGenTile, E - e0);       // elements of this tile
  const size_t base = (size_t)e0 * es + (size_t)comp * cs;
  const float* gt = g + (size_t)e0 * N;       // this tile's factor rows
  const size_t gs = (size_t)E * N;            // one factor array
  for (int t = threadIdx.x; t < kGenTile * N; t += kGenThreads) {
    const int el = t / N, j = t % N;          // element, L-vector column
    const bool in = el < ne;
    s.u[s.hier[j]][el] = in ? u[base + (size_t)el * es + j] : 0.f;
    // the factors are lex ordered: column j is lex node j here
    s.f[j][el] = in ? gt[t] : 0.f;
    s.f[N + j][el] = in ? gt[gs + t] : 0.f;
    g2[j][el] = in ? gt[2 * gs + t] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  gen_flux_by(s, StagedFactors<N>{s, g2, lane}, lane < ne);
  __syncthreads();
  // the tile's u is dead: stage the output rows (hier order) there
  for (int j = w; j < N; j += kGenWarps) s.u[j][lane] = gen_row(s, j, lane);
  __syncthreads();
  for (int t = threadIdx.x; t < ne * N; t += kGenThreads) {
    const int el = t / N, j = t % N;
    out[base + (size_t)el * es + j] = s.u[j][el];
  }
}

template <int N>
cudaError_t launch_laplacian_local(const float* u, const float* g,
                                   const float* Dh, const int* hier,
                                   float* out, int E, int k, long long es,
                                   long long cs, cudaStream_t stream) {
  const int tiles = (E + kGenTile - 1) / kGenTile;
  laplacian_local_kernel<N><<<tiles * k, kGenThreads, 0, stream>>>(
      u, g, Dh, hier, out, E, k, es, cs);
  return cudaGetLastError();
}

}  // namespace sem

// u, out: k arrays of E elements of n f32 values, component c of element e
// at e * es + c * cs; g: (3, E, n) f32 lex-order factors; Dh: (2n, n) f32
// stacked derivative with columns in hier order; hier: (n,) int32.  Returns
// a cudaError_t code (0 on success).
extern "C" int sem_laplacian_local(const void* u, const void* g,
                                   const void* Dh, const void* hier,
                                   void* out, int n, int E, int k,
                                   long long es, long long cs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(g);
  const float* df = static_cast<const float*>(Dh);
  const int* hi = static_cast<const int*>(hier);
  float* of = static_cast<float*>(out);
  if (E <= 0 || k <= 0) return 0;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    return static_cast<int>(sem::launch_laplacian_local<NN>(                \
        uf, gf, df, hi, of, E, k, es, cs, s));
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

