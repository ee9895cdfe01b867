// The node phase's forward on the cluster (node_cluster.cuh), shared by
// kernel 3 (node_mlp.cu), which reads the aggregate from device memory,
// and kernel 10 (agg_node.cu), which sums it on chip:
//
//   out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x
//
// on a tile of TR = RG·RT rows per cluster of CL CTAs (kernel 3: RT = 4,
// 64 rows; see node_mlp.cu for the design). Each output element is one FMA
// chain over k in order, x's half then aggr's, whatever RT is: the same
// arithmetic at every tile height. CW: the latent width (kernel 3: 128 or
// 256, on cl_of(CW) CTAs; kernel 10: 128), each CTA SW columns at either.
#pragma once

#include "node_cluster.cuh"

namespace bsms {
namespace node_cluster {

constexpr int RG = 16;       // row groups
constexpr int NT3 = 8 * RG;  // threads per CTA (8 column groups of 4)
constexpr int KH = 64;       // weight rows per staged slab

// Bytes of shared memory of a tile of RT row groups: A, two exchange
// slices, two weight slabs.
template <int RT, int CW = C>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         ((size_t)RG * RT * as_of(CW) + 2 * RG * RT * SW + 2 * KH * SW);
}

// Issues the copy of slab s (KH rows of the CTA's SW columns) of the
// products' weights in their fixed order (W0's x half, its aggr half, then
// W[0 .. L-1], each CW×CW, CW / KH slabs apiece) into buffer s mod 2.
template <int CW = C>
__device__ __forceinline__ void copy_slab(const float* __restrict__ W0,
                                          const float* __restrict__ W, int s,
                                          int q, float* wbuf) {
  static_assert(CW % KH == 0 && (CW / KH) % 2 == 0,
                "a product's first slab takes buffer 0");
  constexpr int PER = CW / KH;  // slabs per product
  const int p = s / PER;
  const float* src = (p < 2 ? W0 + (size_t)p * CW * CW
                            : W + (size_t)(p - 2) * CW * CW) +
                     (size_t)(s % PER) * KH * CW;
  copy_cols<NT3>(src, CW, KH, q, wbuf + (s & 1) * KH * SW);
}

// acc[i][j] += Σ_k A[(rg + RG·i)·AS + k0 + k] · ws[k·SW + 4·cg + j] over
// k < KH in k order, rg = tid / 8, cg = tid % 8: thread tid's RT rows by 4
// columns of the CTA's output slice. RT rows a thread (rather than kernel
// 6's two on more threads) cut the shared-memory loads per FMA; the rows a
// warp reads at once (rg .. rg + 3) fall on distinct banks.
template <int RT, int CW = C>
__device__ __forceinline__ void slab_product(float (&acc)[RT][4],
                                             const float* A, int k0,
                                             const float* ws) {
  constexpr int AS = as_of(CW);
  const int rg = threadIdx.x >> 3, cg4 = 4 * (threadIdx.x & 7);
#pragma unroll 2
  for (int k = 0; k < KH; k += 4) {
    float4 a[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + RG * i) * AS + k0 + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(ws + (k + kk) * SW + cg4);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(av, v.x, acc[i][0]);
        acc[i][1] = fmaf(av, v.y, acc[i][1]);
        acc[i][2] = fmaf(av, v.z, acc[i][2]);
        acc[i][3] = fmaf(av, v.w, acc[i][3]);
      }
    }
  }
}

// out (a TR×SW slice) = acc + bias[q·SW ..], optionally ReLU'd and rounded
// to bf16, in slab_product's layout.
template <int RT>
__device__ __forceinline__ void store_rows(const float (&acc)[RT][4],
                                           const float* __restrict__ bias,
                                           int q, float* out, bool relu,
                                           bool to_bf16) {
  const int rg = threadIdx.x >> 3, cg4 = 4 * (threadIdx.x & 7);
  const float4 b = *reinterpret_cast<const float4*>(bias + q * SW + cg4);
  const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] + bb[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
      if (to_bf16) v[j] = round_bf16(v[j]);
    }
    *reinterpret_cast<float4*>(out + (rg + RG * i) * SW + cg4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc += A · (product s / PER's weight slice), slab by slab: waits for each
// slab, then issues the next (when there is one) into the other buffer.
// The barrier between them also orders the caller's writes of A before the
// reads and every read of the other buffer before it is overwritten.
template <int RT, int CW = C>
__device__ __forceinline__ void product(float (&acc)[RT][4], const float* A,
                                        const float* __restrict__ W0,
                                        const float* __restrict__ W, int& s,
                                        int n_slabs, int q, float* wbuf) {
  for (int k0 = 0; k0 < CW; k0 += KH, ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_slabs) copy_slab<CW>(W0, W, s + 1, q, wbuf);
    slab_product<RT, CW>(acc, A, k0, wbuf + (s & 1) * KH * SW);
  }
}

// The node phase of tile blockIdx.x / CL (TR = RG·RT rows) on CTA q of its
// cluster, in `smem` (fwd_smem_bytes<RT>()). TX: x's type; TO: the
// output's (bf16 in BF16 mode, else TX). The aggregate comes from
// `aggr`, a front with two steps:
// - aggr.start<BF16, TR>(q, row0, slice): before x is read (kernel 10
//   sums its rows there into `slice`, a TR×SW buffer no peer reads yet,
//   and arrives at the cluster barrier);
// - aggr.fill<BF16, TR>(cluster, row0, slice, A): the tile's full
//   aggregate rows into A (rounded to bf16 in BF16 mode, as dot operands)
//   once every read of x in A is done.
template <typename TX, typename TO, bool BF16, int RT, int CW = C,
          typename Aggr>
__device__ __forceinline__ void node_phase_fwd(
    const TX* __restrict__ x, const Aggr& aggr, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W,
    const float* __restrict__ B, int n_layers, TO* __restrict__ out,
    float* smem) {
  constexpr int TR = RG * RT, CL = cl_of(CW), AS = as_of(CW), V = CW / C;
  float* A = smem;               // [TR][AS] full tile
  float* E = A + TR * AS;        // [2][TR][SW] slices
  float* wbuf = E + 2 * TR * SW;  // [2][KH][SW] weight slabs

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const size_t row0 = (size_t)(blockIdx.x / CL) * TR;
  const int n_slabs = (2 + n_layers) * (CW / KH);
  int s = 0;
  copy_slab<CW>(W0, W, 0, q, wbuf);
  // The aggregate's slice is E's second: the first layer's output takes
  // the first, and the second is written again (by the first tail layer)
  // only after the exchange that follows every peer's read of it.
  aggr.template start<BF16, TR>(q, row0, E + TR * SW);

  // relu(x·Wa + aggr·Wb + b0): one accumulator over both halves.
  {
    float acc[RT][4] = {};
    load_full<TX, BF16, NT3, TR, CW>(x + row0 * CW, A);
    product<RT, CW>(acc, A, W0, W, s, n_slabs, q, wbuf);
    __syncthreads();  // every read of x in A done
    aggr.template fill<BF16, TR>(cluster, row0, E + TR * SW, A);
    product<RT, CW>(acc, A, W0, W, s, n_slabs, q, wbuf);
    store_rows<RT>(acc, b0, q, E, true, BF16);
  }
  exchange<NT3, TR, CW>(cluster, E, A);
  // The tail: the last layer's output (unrounded) assembled in A.
  for (int l = 0; l < n_layers; ++l) {
    float acc[RT][4] = {};
    product<RT, CW>(acc, A, W0, W, s, n_slabs, q, wbuf);
    const bool last = l == n_layers - 1;
    float* slice = E + ((l + 1) & 1) * TR * SW;
    store_rows<RT>(acc, B + l * CW, q, slice, !last, BF16 && !last);
    exchange<NT3, TR, CW>(cluster, slice, A);
  }
  cluster_arrive();  // this CTA's reads of its peers' slices are done
  __syncthreads();

  // The LayerNorm of each row, warp w taking rows w, w + 4, ...: mean,
  // then the mean of squared deviations, then (x − mean) · 1/sqrt(var +
  // eps), 1.0f / sqrtf (both IEEE-rounded without fast math) rather than
  // rsqrtf, as the TPU kernels do. The lanes that hold this CTA's columns
  // write LN + x.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < TR; r += NT3 / 32) {
    float4 v[V];  // lane holds columns 4·lane + C·vv .. +3
#pragma unroll
    for (int vv = 0; vv < V; ++vv)
      v[vv] = *reinterpret_cast<const float4*>(A + r * AS + 4 * lane + C * vv);
    const float inv = ln_center<V>(v);
#pragma unroll
    for (int vv = 0; vv < V; ++vv)
      if ((lane >> 3) + (C / SW) * vv == q) {
        // (v · inv) + x, rounded twice as the plain version is
        const size_t o = (row0 + r) * CW + 4 * lane + C * vv;
        const float4 xv = load4(x + o);
        store(&out[o], __fadd_rn(__fmul_rn(v[vv].x, inv), xv.x));
        store(&out[o + 1], __fadd_rn(__fmul_rn(v[vv].y, inv), xv.y));
        store(&out[o + 2], __fadd_rn(__fmul_rn(v[vv].z, inv), xv.z));
        store(&out[o + 3], __fadd_rn(__fmul_rn(v[vv].w, inv), xv.w));
      }
  }
  // No CTA leaves while a peer may still read its shared memory.
  cluster_wait();
}

}  // namespace node_cluster
}  // namespace bsms
