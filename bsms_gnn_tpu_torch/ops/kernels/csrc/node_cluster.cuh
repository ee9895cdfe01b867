// The thread-block cluster of the node phase's kernels 3 (node_mlp.cu), 6
// (node_mlp_bwd.cu) and 10 (agg_node.cu, its deep levels): CL CTAs per
// 64-row tile (kernel 10: 16 rows), CTA q owning the SW = C / CL output
// columns [q·SW, (q+1)·SW) of every row product, each computed from the
// full tile A (×128) in its shared memory. After a layer, each CTA writes
// its output columns into a rows×SW slice of its own shared memory, and
// after a cluster barrier every CTA copies the CL slices through
// distributed shared memory into its A: the next layer's full input.
//
// A's rows are padded to AS floats, so that the rows a warp reads at once
// fall on distinct banks. Each kernel lays its row products out over its
// own threads (kernel 6: NT threads of 2 rows by 4 columns; kernels 3 and
// 10: NT / 2 threads of RT rows by 4, `node_cluster_fwd.cuh`), so the
// copies below take the CTA's thread count NTH (and the tile's rows).
//
// Width: kernels 3, 6 and 10 take a latent width CW of 128 or 256 (a
// template parameter, C = 128 by default). Each CTA keeps SW
// = 32 output columns, so a tile's cluster is CW / SW CTAs (4 at 128, 8 at
// 256: the portable cluster limit) and the full tile's rows are padded to
// CW + 4 floats (`cl_of`, `as_of`).
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "row_sum.cuh"  // load4

namespace bsms {
namespace node_cluster {

namespace cg = cooperative_groups;

constexpr int CL = 4;       // CTAs per tile (node_mlp.CLUSTER)
constexpr int SW = C / CL;  // output columns per CTA
constexpr int AS = C + 4;   // padded row stride of the full tile
constexpr int NT = THREADS;  // threads per CTA of kernel 6
static_assert(TILE == 64 && SW == 32 && NT == 256,
              "node_mlp.ROWS is TILE, node_mlp.CLUSTER is CL");

// CTAs of a tile's cluster and the full tile's padded row stride at
// latent width cw.
__host__ __device__ constexpr int cl_of(int cw) { return cw / SW; }
__host__ __device__ constexpr int as_of(int cw) { return cw + 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copy of `rows` rows of columns [q·SW, (q+1)·SW) of a row-major
// weight (row stride ld) from `src` into dst[rows][SW] (cp.async, one
// commit group) by the CTA's NTH threads.
template <int NTH = NT>
__device__ __forceinline__ void copy_cols(const float* __restrict__ src,
                                          int ld, int rows, int q,
                                          float* dst) {
  src += q * SW;
  for (int j = threadIdx.x; j < rows * SW / 4; j += NTH) {
    const int k = j / (SW / 4), c4 = 4 * (j % (SW / 4));
    cp_async16(dst + k * SW + c4, src + (size_t)k * ld + c4);
  }
  cp_async_commit();
}

// The cluster barrier in two halves: arrive once this CTA's slice is
// written (release: its writes become visible to the peers), wait before
// reading the peers' (acquire). Work between the two overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A[r][p·SW + c] = slice(p)[r][c] for every CTA p of the cluster, the own
// slice included, after the cluster barrier's wait (so every CTA's slice
// is visible). The caller arrived after writing its slice and, since, has
// finished every read of A in all its threads (a block barrier, or the
// cluster barrier itself); it orders these writes before the next reads
// of A with a block barrier. Each thread's loads of the CL slices go out
// together, before its stores. NTH: the CTA's threads; ROWS: the tile's.
// BY_ROWS: each CTA's slice holds rows [p·ROWS/CL, (p+1)·ROWS/CL) of all C
// columns instead (A[p·ROWS/CL + r][c] = slice(p)[r][c]; the same floats).
// CW: the latent width (cl_of(CW) CTAs); each thread's loads of up to four
// CTAs' slices go out together.
template <int NTH = NT, int ROWS = TILE, bool BY_ROWS = false, int CW = C>
__device__ __forceinline__ void exchange_wait(cg::cluster_group& cluster,
                                              float* slice, float* A) {
  constexpr int CLW = cl_of(CW), ASW = as_of(CW);
  constexpr int PG = CLW < 4 ? CLW : 4;     // CTAs whose loads go together
  constexpr int PER = ROWS * SW / 4 / NTH;  // float4s of a slice per thread
  static_assert(PER * 4 * NTH == ROWS * SW && CLW % PG == 0, "slice shape");
  constexpr int W4 = (BY_ROWS ? CW : SW) / 4;  // float4s of a slice's row
  cluster_wait();
#pragma unroll
  for (int p0 = 0; p0 < CLW; p0 += PG) {
    float4 v[PG][PER];
#pragma unroll
    for (int p = 0; p < PG; ++p) {
      const float4* src = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(slice, p0 + p));
#pragma unroll
      for (int k = 0; k < PER; ++k) v[p][k] = src[threadIdx.x + k * NTH];
    }
#pragma unroll
    for (int p = 0; p < PG; ++p)
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int j = threadIdx.x + k * NTH;
        const int r = j / W4, c4 = 4 * (j % W4);
        float* dst = BY_ROWS ? A + ((p0 + p) * (ROWS / CLW) + r) * ASW + c4
                             : A + r * ASW + (p0 + p) * SW + c4;
        *reinterpret_cast<float4*>(dst) = v[p][k];
      }
  }
}

// The whole exchange, with nothing between arrive and wait.
template <int NTH = NT, int ROWS = TILE, int CW = C>
__device__ __forceinline__ void exchange(cg::cluster_group& cluster,
                                         float* slice, float* A) {
  cluster_arrive();
  exchange_wait<NTH, ROWS, false, CW>(cluster, slice, A);
}

// A ROWS×CW tile of a row-major [n, CW] array into A (rows padded to
// as_of(CW)), rounded to bf16 in BF16 mode (as a dot operand), by the CTA's
// NTH threads; each thread's loads go out together, up to 16 at a time.
template <typename T, bool BF16, int NTH = NT, int ROWS = TILE, int CW = C>
__device__ __forceinline__ void load_full(const T* __restrict__ src, float* A) {
  constexpr int PER = ROWS * CW / 4 / NTH, ASW = as_of(CW);
  constexpr int PG = PER < 16 ? PER : 16;
  static_assert(PER % PG == 0, "tile shape");
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += PG) {
    float4 v[PG];
#pragma unroll
    for (int k = 0; k < PG; ++k)
      v[k] = load4(src + 4 * (threadIdx.x + (k0 + k) * NTH));
#pragma unroll
    for (int k = 0; k < PG; ++k) {
      const int i = 4 * (threadIdx.x + (k0 + k) * NTH);
      if (BF16) {
        v[k].x = round_bf16(v[k].x); v[k].y = round_bf16(v[k].y);
        v[k].z = round_bf16(v[k].z); v[k].w = round_bf16(v[k].w);
      }
      *reinterpret_cast<float4*>(A + (i / CW) * ASW + i % CW) = v[k];
    }
  }
}

}  // namespace node_cluster
}  // namespace bsms
