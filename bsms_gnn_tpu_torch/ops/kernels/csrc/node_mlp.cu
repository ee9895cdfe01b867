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
//   operands), and sums both halves into one accumulator per output.
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
// - Width: the latent width CW is 128 or 256 (a template parameter, chosen
//   at launch): cl_of(CW) CTAs a tile (4, or 8 at 256: the portable
//   cluster limit), each still SW = 32 columns of every product; at 256, A
//   is 65 KB and the CTA holds 97 KB, so two fit on an SM. The cluster's
//   size is a launch attribute (cudaLaunchKernelEx), not a compile-time
//   one, so one template serves both widths.
// Each output element is one FMA chain over k in order (x's half, then
// aggr's), with no atomics: the same result from run to run. The device
// code is node_cluster_fwd.cuh's, shared with kernel 10 (agg_node.cu),
// which feeds it an aggregate summed on chip.
#include <type_traits>

#include "node_cluster_fwd.cuh"

using namespace bsms;
using namespace bsms::node_cluster;

namespace {

constexpr int RT = 4;  // output rows per thread: TILE = RG·RT rows
constexpr int MIN_BLOCKS = 3;
static_assert(RG * RT == TILE, "kernel 3's tile is node_mlp.ROWS");

// The aggregate read from device memory: each CTA loads the tile's full
// rows into A (L2-hot after the first CTA).
template <int CW>
struct AggrIn {
  const float* __restrict__ aggr;
  template <bool BF16, int TR>
  __device__ __forceinline__ void start(int, size_t, float*) const {}
  template <bool BF16, int TR>
  __device__ __forceinline__ void fill(cg::cluster_group&, size_t row0,
                                       float*, float* A) const {
    load_full<float, BF16, NT3, TR, CW>(aggr + row0 * CW, A);
  }
};

// TX: x's type; TO: the output's (bf16 in BF16 mode, else TX); CW: the
// latent width. Launched in clusters of cl_of(CW) CTAs.
template <typename TX, typename TO, bool BF16, int CW>
__global__ void __launch_bounds__(NT3, MIN_BLOCKS)
fused_node_phase_kernel(const TX* __restrict__ x, const float* __restrict__ aggr,
                        const float* __restrict__ W0, const float* __restrict__ b0,
                        const float* __restrict__ W, const float* __restrict__ B,
                        int n_layers, TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  node_phase_fwd<TX, TO, BF16, RT, CW>(x, AggrIn<CW>{aggr}, W0, b0, W, B,
                                       n_layers, out,
                                       reinterpret_cast<float*>(smem4));
}

// The launch configuration of n_tiles tiles at width CW: cl_of(CW) CTAs a
// cluster (`attr` holds the cluster's size).
template <int CW>
cudaLaunchConfig_t config(int n_tiles, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * cl_of(CW));
  cfg.blockDim = dim3(NT3);
  cfg.dynamicSmemBytes = fwd_smem_bytes<RT, CW>();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl_of(CW);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TX, typename TO, bool BF16, int CW>
int occupancy(int* blocks_per_sm, int* clusters) {
  auto kernel = fused_node_phase_kernel<TX, TO, BF16, CW>;
  constexpr size_t smem = fwd_smem_bytes<RT, CW>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      NT3, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<CW>(1, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <typename TX, typename TO, bool BF16, int CW>
int launch(const void* x, const void* aggr, const void* W0, const void* b0,
           const void* W, const void* B, void* out, int n_layers, int n_tiles,
           void* stream) {
  if (n_layers < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  auto kernel = fused_node_phase_kernel<TX, TO, BF16, CW>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_smem_bytes<RT, CW>());
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      config<CW>(n_tiles, (cudaStream_t)stream, &cluster);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const TX*)x, (const float*)aggr, (const float*)W0,
      (const float*)b0, (const float*)W, (const float*)B, n_layers, (TO*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_NODE_PHASE(NAME, TX, TO, BF16)                                  \
  extern "C" int NAME##_occupancy(int width, int* blocks_per_sm,             \
                                  int* clusters) {                            \
    return with_width(width, [&](auto cw) {                                   \
      return occupancy<TX, TO, BF16, decltype(cw)::value>(blocks_per_sm,      \
                                                          clusters);          \
    });                                                                       \
  }                                                                           \
  extern "C" int NAME(const void* x, const void* aggr, const void* W0,       \
                      const void* b0, const void* W, const void* B,          \
                      void* out, int width, int n_layers, int n_tiles,       \
                      void* stream) {                                        \
    return with_width(width, [&](auto cw) {                                   \
      return launch<TX, TO, BF16, decltype(cw)::value>(                       \
          x, aggr, W0, b0, W, B, out, n_layers, n_tiles, stream);             \
    });                                                                       \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`).
FUSED_NODE_PHASE(fused_node_phase_f32, float, float, false)
FUSED_NODE_PHASE(fused_node_phase_bf16, __nv_bfloat16, __nv_bfloat16, true)
FUSED_NODE_PHASE(fused_node_phase_f32_bf16, float, __nv_bfloat16, true)
