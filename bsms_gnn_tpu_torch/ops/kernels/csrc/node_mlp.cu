// Kernel 3: the fused GMP node phase (see ../node_mlp.py), replacing the
// TPU kernel `bsms_gnn_tpu/ops/pallas/node_mlp.py:107` (`_get_fwd`):
//
//   out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x
//
// What bounds it: operations, in true f32 on the CUDA cores (no TF32):
// 2 + L products of 64×128×128 per 64-row tile, against 768 bytes per row
// in f32.
//
// What the design does about it: kernel 6's thread-block cluster
// (node_cluster.cuh), CL CTAs per 64-row tile, CTA q computing the output
// columns [q·SW, (q+1)·SW) of every product from the full input tile, so
// the tile's serial chain of products is CL times shorter and a level of n
// tiles runs CL·n CTAs (the 5k airfoil's levels hold 82 tiles down to 2: a
// block per tile left every level on fewer SMs than the card has).
// - Row products: NT3 = 128 threads, each owning RT = 4 rows by 4 columns
//   of the CTA's 64×32 output slice, every output summed over k in order
//   by one FMA chain. Four rows a thread load a third fewer shared-memory
//   operands per FMA than two rows on 256 threads (kernel 6's layout); on
//   an H100 two rows read slower at level 0 and eight rows on 64 threads
//   slower at every level (PERF.md §6).
// - First layer: every CTA reads the tile's full x rows, then its full
//   aggr rows, into A (L2-hot; rounded to bf16 in BF16 mode, as dot
//   operands), and sums both halves into one accumulator per output, as
//   the one-block kernel did.
// - Exchanges: after the first layer and after each tail layer the cluster
//   assembles the next full input in every CTA's A from the CTAs' column
//   slices through distributed shared memory (1 + L exchanges). The
//   slices alternate between two buffers, so one cluster barrier per
//   exchange suffices: a slice is written again only after every peer has
//   passed the barrier that follows its reads.
// - The LayerNorm runs whole in every CTA on the last exchange's full rows
//   (the same code on the same values); CTA q writes its own columns of
//   LN + x, x read again in f32 (unrounded). The cluster's last barrier is
//   split around it: a CTA arrives once it has read its peers' slices and
//   waits before it leaves.
// - Weights: each CTA stages only its SW columns of each product's
//   weight, in 64-row slabs double-buffered with cp.async, the next slab in
//   flight while the current one is used (one barrier per slab); in BF16
//   mode they come already rounded to bf16 (stored as f32).
// - Shared memory: A (33 KB), two exchange slices (8 KB each), two weight
//   slabs (8 KB each): 65 KB, so three CTAs fit on an SM and the airfoil's
//   level 0 (82 clusters) runs in one wave (92 clusters at once on an
//   H100, `occupancy`).
// Each output element is summed in the one-block kernel's order, with no
// atomics: the same arithmetic, the same result from run to run.
#include "node_cluster.cuh"

using namespace bsms;
using namespace bsms::node_cluster;

namespace {

constexpr int RT = 4;           // output rows per thread
constexpr int RG = TILE / RT;   // row groups
constexpr int NT3 = 8 * RG;     // threads per CTA (8 column groups of 4)
constexpr int KH = 64;          // weight rows per staged slab
constexpr int MIN_BLOCKS = 3;
static_assert(C % KH == 0 && (C / KH) % 2 == 0,
              "a product's first slab takes buffer 0");

// Floats of shared memory: A, two exchange slices, two weight slabs.
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)TILE * AS + 2 * TILE * SW + 2 * KH * SW);

// Issues the copy of slab s (KH rows of the CTA's SW columns) of the
// products' weights in their fixed order (W0's x half, its aggr half, then
// W[0 .. L-1], each C×C, C / KH slabs apiece) into buffer s mod 2.
__device__ __forceinline__ void copy_slab(const float* __restrict__ W0,
                                          const float* __restrict__ W, int s,
                                          int q, float* wbuf) {
  constexpr int PER = C / KH;  // slabs per product
  const int p = s / PER;
  const float* src = (p < 2 ? W0 + (size_t)p * C * C
                            : W + (size_t)(p - 2) * C * C) +
                     (size_t)(s % PER) * KH * C;
  copy_cols<NT3>(src, C, KH, q, wbuf + (s & 1) * KH * SW);
}

// acc[i][j] += Σ_k A[(rg + RG·i)·AS + k0 + k] · ws[k·SW + 4·cg + j] over
// k < KH in k order, rg = tid / 8, cg = tid % 8: thread tid's RT rows by 4
// columns of the CTA's output slice. RT rows a thread (rather than kernel
// 6's two on more threads) cut the shared-memory loads per FMA; the rows a
// warp reads at once (rg .. rg + 3) fall on distinct banks.
__device__ __forceinline__ void slab_product(float (&acc)[RT][4],
                                             const float* A, int k0,
                                             const float* ws) {
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

// out (a TILE×SW slice) = acc + bias[q·SW ..], optionally ReLU'd and
// rounded to bf16, in slab_product's layout.
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
__device__ __forceinline__ void product(float (&acc)[RT][4], const float* A,
                                        const float* __restrict__ W0,
                                        const float* __restrict__ W, int& s,
                                        int n_slabs, int q, float* wbuf) {
  for (int k0 = 0; k0 < C; k0 += KH, ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < n_slabs) copy_slab(W0, W, s + 1, q, wbuf);
    slab_product(acc, A, k0, wbuf + (s & 1) * KH * SW);
  }
}

// TX: x's type; TO: the output's (bf16 in BF16 mode, else TX).
template <typename TX, typename TO, bool BF16>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT3, MIN_BLOCKS)
fused_node_phase_kernel(const TX* __restrict__ x, const float* __restrict__ aggr,
                        const float* __restrict__ W0, const float* __restrict__ b0,
                        const float* __restrict__ W, const float* __restrict__ B,
                        int n_layers, TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // [TILE][AS] full tile
  float* E = A + TILE * AS;                     // [2][TILE][SW] slices
  float* wbuf = E + 2 * TILE * SW;              // [2][KH][SW] weight slabs

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const size_t row0 = (size_t)(blockIdx.x / CL) * TILE;
  const int n_slabs = (2 + n_layers) * (C / KH);
  int s = 0;
  copy_slab(W0, W, 0, q, wbuf);

  // relu(x·Wa + aggr·Wb + b0): one accumulator over both halves.
  {
    float acc[RT][4] = {};
    load_full<TX, BF16, NT3>(x + row0 * C, A);
    product(acc, A, W0, W, s, n_slabs, q, wbuf);
    __syncthreads();  // every read of x in A done
    load_full<float, BF16, NT3>(aggr + row0 * C, A);
    product(acc, A, W0, W, s, n_slabs, q, wbuf);
    store_rows(acc, b0, q, E, true, BF16);
  }
  exchange<NT3>(cluster, E, A);
  // The tail: the last layer's output (unrounded) assembled in A.
  for (int l = 0; l < n_layers; ++l) {
    float acc[RT][4] = {};
    product(acc, A, W0, W, s, n_slabs, q, wbuf);
    const bool last = l == n_layers - 1;
    float* slice = E + ((l + 1) & 1) * TILE * SW;
    store_rows(acc, B + l * C, q, slice, !last, BF16 && !last);
    exchange<NT3>(cluster, slice, A);
  }
  cluster_arrive();  // this CTA's reads of its peers' slices are done
  __syncthreads();

  // The LayerNorm of each row (as tile_layer_norm computes it), warp w
  // taking rows w, w + 4, ...; the lanes that hold this CTA's columns
  // write LN + x.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool own = (lane >> 3) == q;  // lane holds columns 4·lane .. +3
  for (int r = warp; r < TILE; r += NT3 / 32) {
    float4 v = *reinterpret_cast<const float4*>(A + r * AS + 4 * lane);
    const float mean = warp_sum(v.x + v.y + v.z + v.w) / C;
    v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
    const float var = warp_sum(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w) / C;
    const float inv = 1.0f / sqrtf(var + LN_EPS);
    if (own) {  // (v · inv) + x, rounded twice as the plain version is
      const size_t o = (row0 + r) * C + 4 * lane;
      const float4 xv = load4(x + o);
      store(&out[o], __fadd_rn(__fmul_rn(v.x, inv), xv.x));
      store(&out[o + 1], __fadd_rn(__fmul_rn(v.y, inv), xv.y));
      store(&out[o + 2], __fadd_rn(__fmul_rn(v.z, inv), xv.z));
      store(&out[o + 3], __fadd_rn(__fmul_rn(v.w, inv), xv.w));
    }
  }
  // No CTA leaves while a peer may still read its shared memory.
  cluster_wait();
}

template <typename TX, typename TO, bool BF16>
int occupancy(int* blocks_per_sm, int* clusters) {
  auto kernel = fused_node_phase_kernel<TX, TO, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      NT3, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(NT3);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <typename TX, typename TO, bool BF16>
int launch(const void* x, const void* aggr, const void* W0, const void* b0,
           const void* W, const void* B, void* out, int n_layers, int n_tiles,
           void* stream) {
  if (n_layers < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  auto kernel = fused_node_phase_kernel<TX, TO, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_tiles * CL, NT3, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const TX*)x, (const float*)aggr, (const float*)W0, (const float*)b0,
      (const float*)W, (const float*)B, n_layers, (TO*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_NODE_PHASE(NAME, TX, TO, BF16)                                  \
  extern "C" int NAME##_occupancy(int* blocks_per_sm, int* clusters) {       \
    return occupancy<TX, TO, BF16>(blocks_per_sm, clusters);                 \
  }                                                                           \
  extern "C" int NAME(const void* x, const void* aggr, const void* W0,       \
                      const void* b0, const void* W, const void* B,          \
                      void* out, int n_layers, int n_tiles, void* stream) {  \
    return launch<TX, TO, BF16>(x, aggr, W0, b0, W, B, out, n_layers,        \
                                n_tiles, stream);                            \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`).
FUSED_NODE_PHASE(fused_node_phase_f32, float, float, false)
FUSED_NODE_PHASE(fused_node_phase_bf16, __nv_bfloat16, __nv_bfloat16, true)
FUSED_NODE_PHASE(fused_node_phase_f32_bf16, float, __nv_bfloat16, true)
