// The p = 1 apply kernels (n = 4, the p-multigrid coarse level): the
// element product and the direct stiffness summation in one launch.
//
// At n = 4 every node is a vertex: all four rows of every element are
// exchanged, each with the three other elements around its vertex, so the
// two-launch form of the p >= 2 applies (product into a scratch B, then
// the class gather from B) moves the whole product through B and costs two
// launches.  Here a block takes a tile of consecutive elements of one RHS
// (P1Classes.tile) and computes, into shared
// memory, the products of every element its sums read: for each window of
// the class table, the tile's elements shifted by the window's deltas
// (elements [b0 + lo, b0 + hi + tile), b0 the tile's first element).
// After one barrier, each thread takes elements e of the tile: it starts
// from e's own rows (delta 0 is in a window) and adds every entry whose
// mask is set at e, with e + delta inside [0, E), from the slot of its
// delta.  Nothing is written but out (and, for a far split, the raw rows
// into B).
//
// The roll classes' deltas cluster: on a structured mesh of nx elements a
// row, {-nx - 1, -nx, -nx + 1}, {-1, 0, 1} and {nx - 1, nx, nx + 1}; with a
// tile of at least nx - 1 elements their ranges meet and make one window
// of tile + 2 nx + 2 products, so each product is formed (tile + 2 nx +
// 2) / tile times (1.6 at nx = 316 and a tile of 1,024) instead of nine
// times (once for each neighbour, the recompute of a thread per element),
// and every read of u and of the coefficients is a contiguous run,
// coalesced.  kP1Unroll products per thread have their reads in flight
// together.
//
// Masks: a plan's own class masks are static, so the host packs the ones
// its entries read into one 32-bit word per element (bit[i] of entry i),
// read before the products, one read per element instead of one byte read
// per entry; the block apply's runtime masks (a shard's slice) are read
// as bytes.
//
// Measured on an H100 (scripts/torch_p1_variants.py, PERF.md): the window
// form beat a thread per element recomputing its neighbours and a
// cooperative launch (products into B, a grid barrier, the gather from B);
// 2 products in flight per thread (80 registers, no spills) beat 4 (105,
// or spills under a bound of 3 blocks per SM); the packed words beat the
// byte reads; a tile of 256 elements was fastest for one RHS and 1,024 for
// a stack of 4 (P1Classes.tile, chosen on the host).
//
// Order of the sums: each destination row starts from the element's own
// row and adds its entries in the plan's order, as roll_dss_T (the plain
// version) does: the table keeps the plan's CSR order (by destination
// row, class order within a row).
//
// The products round as the plain versions' PyTorch operations do: each
// dot product as one chain of fused multiply-adds, each elementwise
// product and sum on its own (__fmul_rn, __fadd_rn: no contraction).
#pragma once

#include <cuda_runtime.h>

#include <cstring>

namespace sem {

constexpr int kP1Threads = 256;       // threads per block
constexpr int kP1Slots = 3072;        // products in shared memory (48 KB)
constexpr int kP1MaxWindows = 8;      // windows of a plan
constexpr int kP1MaxEntries = 32;     // class entries of a plan
constexpr int kP1Unroll = 2;          // products per thread in flight
constexpr int kP1MaxTile = 1024;      // elements per block at most

// The class entries of a DSSPlan at n = 4 (built on the host by
// ops/kernels.py p1_classes for one tile size), by value.  A block takes
// the tile elements from b0 = blockIdx.x * tile; window w holds the
// products of elements b0 + lo[w] + [0, base[w + 1] - base[w]) in slots
// base[w] on.  Entry i adds row src[i] of element e + delta[i] (slot
// e - b0 + slot[i]) into row dst[i] of element e where mask row mask[i] is
// set at e (bit bit[i] of e's word when the masks are packed); the
// element's own rows are slot e - b0 + own_slot.  Entries in the plan's
// CSR order; unused slots hold 0.
struct P1Classes {
  int tile;
  int n_windows;
  int lo[kP1MaxWindows];
  int base[kP1MaxWindows + 1];
  int n_entries;
  int own_slot;
  int delta[kP1MaxEntries];
  unsigned short slot[kP1MaxEntries];
  unsigned short mask[kP1MaxEntries];
  unsigned char bit[kP1MaxEntries];
  unsigned char dst[kP1MaxEntries];
  unsigned char src[kP1MaxEntries];
};

// The affine product at n = 4: S = a0 K0 u + a1 K1 u + a2 K2 u with the
// blocks K[c][i][j] = Kst[c, i, j] (L-vector order) by value, and the
// coefficients of one element, coef[q * E + e] = aT[q, e].
struct AffineP1 {
  static constexpr int kCoef = 3;
  struct Tables {
    float K[3][4][4];
  };
  __device__ static __forceinline__ void product(const Tables& t,
                                                 const float (&x)[4],
                                                 const float (&c)[kCoef],
                                                 float (&S)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float V[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) v = fmaf(t.K[k][i][j], x[j], v);
        V[k] = v;
      }
      S[i] = __fadd_rn(
          __fadd_rn(__fmul_rn(c[0], V[0]), __fmul_rn(c[1], V[1])),
          __fmul_rn(c[2], V[2]));
    }
  }
};

// The curved product at n = 4: [ur; us] = Dh u, the flux
// [g0 ur + g1 us; g1 ur + g2 us], S = Dh^T flux, with Dh (8, 4) by value
// (rows lex, columns in the L-vector order) and the factors of one
// element, coef[(c * 4 + i) * E + e] = gT[c, i, e] (lex node i).
struct GeneralP1 {
  static constexpr int kCoef = 12;
  struct Tables {
    float Dh[8][4];
  };
  __device__ static __forceinline__ void product(const Tables& t,
                                                 const float (&x)[4],
                                                 const float (&g)[kCoef],
                                                 float (&S)[4]) {
    float gr[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) v = fmaf(t.Dh[q][j], x[j], v);
      gr[q] = v;
    }
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __fadd_rn(__fmul_rn(g[i], gr[i]),
                       __fmul_rn(g[4 + i], gr[4 + i]));
      f[4 + i] = __fadd_rn(__fmul_rn(g[4 + i], gr[i]),
                           __fmul_rn(g[8 + i], gr[4 + i]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) v = fmaf(t.Dh[q][j], f[q], v);
      S[j] = v;
    }
  }
};

// out = DSS(local product) on a (k * 4, E) stack, the RHS blockIdx.y; with
// B non-null the raw rows [0, nb) of the product go to B (k, nb, E) too.
// PACKED: bits (E,) holds each element's packed mask word; else masks
// (C, E) bool, a block's runtime slice.  A source e + delta outside [0, E)
// counts as zero either way.
template <class Op, bool PACKED>
__global__ void __launch_bounds__(kP1Threads)
    p1_apply_dss_kernel(const float* __restrict__ u,
                        const typename Op::Tables t,
                        const float* __restrict__ coef,
                        const bool* __restrict__ masks,
                        const unsigned* __restrict__ bits,
                        const P1Classes cls, float* __restrict__ out,
                        float* __restrict__ B, int E, int nb) {
  // the windows' products, row r of slot j at P[r * items + j]; a slot
  // outside [0, E) computes element 0 (never read)
  extern __shared__ float P[];
  const int b0 = blockIdx.x * cls.tile, tid = threadIdx.x;
  const int items = cls.base[cls.n_windows];
  u += (size_t)blockIdx.y * 4 * E;
  // the packed mask words of this thread's elements, read before anything
  // waits on a read
  unsigned word[kP1MaxTile / kP1Threads];
#pragma unroll
  for (int i = 0; i < kP1MaxTile / kP1Threads; ++i) {
    const int e = b0 + tid + i * kP1Threads;
    word[i] = PACKED && tid + i * kP1Threads < cls.tile && e < E ? bits[e]
                                                                : 0u;
  }
  for (int j0 = 0; j0 < items; j0 += kP1Unroll * kP1Threads) {
    float x[kP1Unroll][4], c[kP1Unroll][Op::kCoef];
#pragma unroll
    for (int i = 0; i < kP1Unroll; ++i) {
      const int j = min(j0 + i * kP1Threads + tid, items - 1);
      int w = 0;
      while (j >= cls.base[w + 1]) ++w;
      int s = b0 + cls.lo[w] + j - cls.base[w];
      s = s < 0 || s >= E ? 0 : s;
#pragma unroll
      for (int r = 0; r < 4; ++r) x[i][r] = u[(size_t)r * E + s];
#pragma unroll
      for (int q = 0; q < Op::kCoef; ++q) c[i][q] = coef[(size_t)q * E + s];
    }
#pragma unroll
    for (int i = 0; i < kP1Unroll; ++i) {
      const int j = j0 + i * kP1Threads + tid;
      if (j >= items) break;
      float S[4];
      Op::product(t, x[i], c[i], S);
#pragma unroll
      for (int r = 0; r < 4; ++r) P[r * items + j] = S[r];
    }
  }
  __syncthreads();
  out += (size_t)blockIdx.y * 4 * E;
  if (B != nullptr) B += (size_t)blockIdx.y * nb * E;
#pragma unroll
  for (int it = 0; it < kP1MaxTile / kP1Threads; ++it) {
    const int el = tid + it * kP1Threads, e = b0 + el;
    if (el >= cls.tile || e >= E) break;
    float acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = P[r * items + cls.own_slot + el];
    if (B != nullptr) {
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (d < nb) B[(size_t)d * E + e] = acc[d];
    }
    for (int i0 = 0; i0 < cls.n_entries; i0 += 16) {
      bool on[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = i0 + i, s = e + cls.delta[q & (kP1MaxEntries - 1)];
        on[i] = q < cls.n_entries && s >= 0 && s < E
                && (PACKED ? (word[it] >> cls.bit[q]) & 1u
                           : masks[(size_t)cls.mask[q] * E + e]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int q = i0 + i;
        if (q >= cls.n_entries) break;
        if (!on[i]) continue;
        const float v = P[cls.src[q] * items + cls.slot[q] + el];
        const int dst = cls.dst[q];
#pragma unroll
        for (int d = 0; d < 4; ++d)
          acc[d] = dst == d ? __fadd_rn(acc[d], v) : acc[d];
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) out[(size_t)d * E + e] = acc[d];
  }
}

// One launch of the apply: tables, classes are host pointers to an
// Op::Tables and a P1Classes (copied here, then passed by value); the
// packed mask words when bits is not null, else the byte masks.
template <class Op>
cudaError_t launch_p1_apply_dss(const void* u, const void* tables,
                                const void* coef, const void* masks,
                                const void* bits, const void* classes,
                                void* out, void* B, int E, int nb, int k,
                                cudaStream_t stream) {
  typename Op::Tables t;
  P1Classes cls;
  std::memcpy(&t, tables, sizeof t);
  std::memcpy(&cls, classes, sizeof cls);
  if (cls.tile < 1 || cls.tile > kP1MaxTile || cls.n_windows < 1
      || cls.n_windows > kP1MaxWindows
      || cls.base[cls.n_windows] > kP1Slots || cls.n_entries < 0
      || cls.n_entries > kP1MaxEntries || nb > 4)
    return cudaErrorInvalidValue;
  const dim3 grid((E + cls.tile - 1) / cls.tile, k);
  const size_t smem = 4 * sizeof(float) * cls.base[cls.n_windows];
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(coef);
  const bool* mf = static_cast<const bool*>(masks);
  const unsigned* bf = static_cast<const unsigned*>(bits);
  float* of = static_cast<float*>(out);
  float* Bf = static_cast<float*>(B);
  if (bits != nullptr)
    p1_apply_dss_kernel<Op, true><<<grid, kP1Threads, smem, stream>>>(
        uf, t, cf, mf, bf, cls, of, Bf, E, nb);
  else
    p1_apply_dss_kernel<Op, false><<<grid, kP1Threads, smem, stream>>>(
        uf, t, cf, mf, bf, cls, of, Bf, E, nb);
  return cudaGetLastError();
}

}  // namespace sem

// The size of the by-value class table, for the host side's check of its
// layout.
extern "C" int sem_p1_classes_size() {
  return static_cast<int>(sizeof(sem::P1Classes));
}
