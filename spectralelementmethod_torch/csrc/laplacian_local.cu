// laplacian_local: the element-local weak Laplacian on row-major (E, n) f32
// L-vectors, without DSS,
//
//   [ur us] = u Dh^T,   [fr fs] = [g0 ur + g1 us, g1 ur + g2 us],
//   out = [fr fs] Dh,
//
// for one array, for k arrays stacked as (k, E, n), or for k components
// packed side by side as (E, k n): the kernel takes an element stride es and
// a component stride cs (in floats), and component c of element e starts at
// e * es + c * cs.  The factors g (3, E, n, lex order) and Dh are shared by
// the k.
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
// k arrays or components read the factors once: 8 k + 12 B per node.
//
// Design: the curved product of sem_curved.cuh on the (E, n) layout.  A
// block takes a tile of kAffTile = 32 elements, one per lane, and M warps;
// warp w owns the column line (., w) and the row line (w, .) of every
// element of the tile, and D0, D1, their transposes and the lex-to-row map
// come by value in GeneralTables (ops/kernels.py GeneralFactors), so no
// block sets up tables.  In this layout a tile's u, each of its three
// factor arrays and its output are each one contiguous run of 32 n floats
// (10,368 B at p = 8): the block copies them whole into shared memory with
// 16-byte cp.async (no register holds them; zeros past the last element),
// u first, and forms the gradients while the factors land.  The lines read
// the linear staging directly: node j of element `lane` sits at lane * P +
// j, and with the pitch P = n odd (n + 1 for even n) a warp's 32 lanes hit
// 32 banks, so u needs no hand-over.  Two hand-overs remain (g1 ur from the
// column lines, us from the row lines) and the column sums of S go back
// through u's dead slot; S is staged in L-vector order in the dead g1 ur
// slot and stored as one contiguous run with 16-byte stores.  Runs that are
// not 16-byte aligned (E n not a multiple of 4, the packed form's strided
// runs, even n) are staged with 4-byte copies at pitch P instead.
//
// k arrays or components: one block per tile stages the factors once and
// loops over the k components, with u of component c + 1 in flight (a
// second u buffer) during the product of c.  (A block per tile and
// component, the component the fastest grid index so that the k blocks of
// a tile read its factors through L2, took 0.158 ms at k = 4 against the
// loop's 0.144 on an H100 80GB HBM3 at 700 W, scripts/torch_ab_local.py.)
// Shared memory at p = 8: 62 KB per block, 72 KB with the second buffer;
// 3 blocks fit an SM either way.  No TPU mechanism is carried over: the
// FMAs are true f32 and no block-diagonal matrices are formed.
#include <cstring>

#include "sem_curved.cuh"

namespace sem {

// resident blocks per SM in the launch bounds (M warps each)
constexpr int kLocalMinBlocks = 3;

// the staging's row pitch: odd, so that 32 lanes at lane * P fall in 32
// distinct banks
template <int N>
__host__ __device__ constexpr int local_pitch() {
  return N % 2 ? N : N + 1;
}

// NU u buffers (2 for k > 1 components), the factors, and the two
// hand-overs, each a tile of 32 elements at pitch P
template <int N, int NU>
struct LocalSmem {
  static constexpr int T = kAffTile * local_pitch<N>();
  float u[NU][T];   // u, then the column sums of S
  float g[3][T];    // g0, g1, g2 (lex)
  float r[T];       // g1 ur (lex), then S (L-vector order) for the store
  float s[T];       // us (lex)
};

extern __shared__ __align__(16) unsigned char local_smem[];

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One 16-byte asynchronous copy from device to shared memory that reads
// `bytes` (0..16) and zero-fills the rest.
__device__ __forceinline__ void stage16(float* dst, const float* src,
                                        int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Issue the copies of one tile of ne elements, element el's n floats at
// src + el * es, into dst at pitch P (zeros for the elements past ne).
// VEC: one contiguous 16-byte aligned run (es == N, P == N), as 16-byte
// copies.
template <int N, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long es, int ne) {
  constexpr int P = local_pitch<N>();
  if constexpr (VEC) {
    const int bytes = ne * N * 4;
    for (int i = threadIdx.x; i < kAffTile * N / 4; i += blockDim.x) {
      const int b = min(max(bytes - 16 * i, 0), 16);
      stage16(dst + 4 * i, b ? src + 4 * i : src, b);
    }
  } else {
    for (int t = threadIdx.x; t < kAffTile * N; t += blockDim.x) {
      const int el = t / N, j = t - el * N;
      const bool in = el < ne;
      stage4(dst + el * P + j, in ? src + el * es + j : src, in);
    }
  }
}

// Store the tile's ne staged rows (pitch P) to dst + el * es; VEC as one
// contiguous run with 16-byte stores.
template <int N, bool VEC>
__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           long long es, int ne) {
  constexpr int P = local_pitch<N>();
  if constexpr (VEC) {
    const int nf = ne * N, n4 = nf / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    for (int t = 4 * n4 + threadIdx.x; t < nf; t += blockDim.x)
      dst[t] = src[t];
  } else {
    for (int t = threadIdx.x; t < ne * N; t += blockDim.x) {
      const int el = t / N, j = t - el * N;
      dst[el * es + j] = src[el * P + j];
    }
  }
}

// Block b: tile b, its k components in turn.
template <int N, bool VEC, int NU>
__global__ void __launch_bounds__(aff_threads<N>(), kLocalMinBlocks)
    laplacian_local_kernel(const float* __restrict__ u,
                           const float* __restrict__ g,
                           const GeneralTables t, float* __restrict__ out,
                           int E, int k, long long es, long long cs) {
  constexpr int M = grid_side(N), P = local_pitch<N>();
  LocalSmem<N, NU>& sm = *reinterpret_cast<LocalSmem<N, NU>*>(local_smem);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e0 = blockIdx.x * kAffTile, ne = min(kAffTile, E - e0);
  const float* ut = u + (size_t)e0 * es;
  float* ot = out + (size_t)e0 * es;
  const size_t gs = (size_t)E * N;
  // the groups in order: u of the first component, the factors, then u of
  // each next component (an empty group when there is none)
  stage_tile<N, VEC>(sm.u[0], ut, es, ne);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < 3; ++c)
    stage_tile<N, VEC>(sm.g[c], g + c * gs + (size_t)e0 * N, N, ne);
  cp_async_commit();
  const int ul = lane * P;             // this lane's element in the staging
  const float* g0 = sm.g[0] + ul;
  const float* g1 = sm.g[1] + ul;
  const float* g2 = sm.g[2] + ul;
  float* hr = sm.r + ul;
  float* hs = sm.s + ul;
  for (int i = 0; i < k; ++i) {
    float* su = sm.u[i % NU] + ul;
    if (i + 1 < k)
      stage_tile<N, VEC>(sm.u[(i + 1) % NU], ut + (size_t)(i + 1) * cs, es,
                         ne);
    cp_async_commit();
    if (i == 0)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    __syncthreads();
    // ur on the column line (a, w), us on the row line (w, a), straight
    // from the staged u (lex node q at row t.row[q])
    float ur[M], us[M];
    {
      float x[M], y[M];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        x[a] = su[t.row[a * M + w]];
        y[a] = su[t.row[w * M + a]];
      }
#pragma unroll
      for (int a = 0; a < M; ++a) {
        float gr = 0.f, gs_ = 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          gr = fmaf(t.D0[a * M + m], x[m], gr);
          gs_ = fmaf(t.D1[a * M + m], y[m], gs_);
        }
        ur[a] = gr;
        us[a] = gs_;
      }
    }
    if (i == 0) {
      cp_async_wait<1>();              // the factors have landed
      __syncthreads();
    }
    // the hand-overs: g1 ur from the column line, us from the row line,
    // which forms g2 us (products rounded: no contraction)
    float g2us[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      hr[a * M + w] = __fmul_rn(g1[a * M + w], ur[a]);
      g2us[a] = __fmul_rn(g2[w * M + a], us[a]);
      hs[w * M + a] = us[a];
    }
    __syncthreads();
    // fr on the column line, fs on the row line; the column sums of S at
    // (m, w) into u's slot (dead: read before the last barrier), the row
    // sums at (w, c) in S
    float S[M];
    {
      float fr[M], fs[M];
#pragma unroll
      for (int a = 0; a < M; ++a) {
        fr[a] = fmaf(g0[a * M + w], ur[a],
                     __fmul_rn(g1[a * M + w], hs[a * M + w]));
        fs[a] = __fadd_rn(g2us[a], hr[w * M + a]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float sc = 0.f, sr = 0.f;
#pragma unroll
        for (int a = 0; a < M; ++a) {
          sc = fmaf(t.D0t[m * M + a], fr[a], sc);
          sr = fmaf(t.D1t[m * M + a], fs[a], sr);
        }
        su[m * M + w] = sc;
        S[m] = sr;
      }
    }
    __syncthreads();
    // S of the row line, in L-vector order, into the g1 ur slot (dead)
#pragma unroll
    for (int c = 0; c < M; ++c)
      hr[t.row[w * M + c]] = S[c] + su[w * M + c];
    __syncthreads();
    store_tile<N, VEC>(ot + (size_t)i * cs, sm.r, es, ne);
  }
}

// The dynamic shared memory of one variant, set once per kernel and device
// (internal linkage, as curved_smem_attribute).
template <int N, bool VEC, int NU>
static cudaError_t local_smem_attribute() {
  static OncePerDevice once;
  return once([] {
    return cudaFuncSetAttribute(laplacian_local_kernel<N, VEC, NU>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(LocalSmem<N, NU>)));
  });
}

template <int N, bool VEC, int NU>
cudaError_t launch_local(const float* u, const float* g,
                         const GeneralTables& t, float* out, int E, int k,
                         long long es, long long cs, cudaStream_t stream) {
  const cudaError_t err = local_smem_attribute<N, VEC, NU>();
  if (err != cudaSuccess) return err;
  const int tiles = (E + kAffTile - 1) / kAffTile;
  laplacian_local_kernel<N, VEC, NU><<<tiles, aff_threads<N>(),
                                       sizeof(LocalSmem<N, NU>), stream>>>(
      u, g, t, out, E, k, es, cs);
  return cudaGetLastError();
}

template <int N, bool VEC, int NU>
int local_occupancy(int* smem_bytes) {
  *smem_bytes = static_cast<int>(sizeof(LocalSmem<N, NU>));
  int blocks = 0;
  if (local_smem_attribute<N, VEC, NU>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, laplacian_local_kernel<N, VEC, NU>, aff_threads<N>(),
          *smem_bytes) != cudaSuccess)
    return 0;
  return blocks;
}

// The variants: 16-byte staging (vec) or 4-byte; one u buffer or two.
template <int N>
cudaError_t launch_laplacian_local(const float* u, const float* g,
                                   const GeneralTables& t, float* out, int E,
                                   int k, long long es, long long cs,
                                   bool vec, cudaStream_t stream) {
  if (vec && (N % 2 == 0 || es != N ||
              ((reinterpret_cast<uintptr_t>(u) |
                reinterpret_cast<uintptr_t>(g) |
                reinterpret_cast<uintptr_t>(out)) & 15) ||
              ((long long)E * N) % 4 || cs % 4))
    return cudaErrorInvalidValue;
  if (vec)
    return k > 1 ? launch_local<N, true, 2>(u, g, t, out, E, k, es, cs, stream)
                 : launch_local<N, true, 1>(u, g, t, out, E, k, es, cs,
                                            stream);
  return k > 1 ? launch_local<N, false, 2>(u, g, t, out, E, k, es, cs, stream)
               : launch_local<N, false, 1>(u, g, t, out, E, k, es, cs, stream);
}

}  // namespace sem

// The size of GeneralTables, for the host side's check of its layout.
extern "C" int sem_general_tables_size() {
  return static_cast<int>(sizeof(sem::GeneralTables));
}

// u, out: k arrays of E elements of n f32 values, component c of element e
// at e * es + c * cs; g: (3, E, n) f32 lex-order factors; tables: host
// pointer to the operator's GeneralTables (sem_curved.cuh; copied here,
// then passed by value).  vec: stage by 16-byte copies (n odd, es == n, the
// runs 16-byte aligned).  Returns a cudaError_t code (0 on success).
extern "C" int sem_laplacian_local(const void* u, const void* g,
                                   const void* tables, void* out, int n,
                                   int E, int k, long long es, long long cs,
                                   int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sem::GeneralTables t;
  std::memcpy(&t, tables, sizeof t);
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(g);
  float* of = static_cast<float*>(out);
  if (E <= 0 || k <= 0) return 0;
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    return static_cast<int>(sem::launch_laplacian_local<NN>(                \
        uf, gf, t, of, E, k, es, cs, vec != 0, s));
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of a variant (vec, one u buffer or two for
// k > 1) at n, in bytes, and the blocks of it that fit one SM of the
// current device (0 on an error).
extern "C" int sem_laplacian_local_occupancy(int n, int vec, int k,
                                             int* smem_bytes) {
  switch (n) {
#define SEM_CASE(NN)                                                        \
  case NN:                                                                  \
    return vec ? (k > 1 ? sem::local_occupancy<NN, true, 2>(smem_bytes)     \
                        : sem::local_occupancy<NN, true, 1>(smem_bytes))    \
               : (k > 1 ? sem::local_occupancy<NN, false, 2>(smem_bytes)    \
                        : sem::local_occupancy<NN, false, 1>(smem_bytes));
    SEM_FOR_EACH_N(SEM_CASE)
#undef SEM_CASE
    default:
      return 0;
  }
}
