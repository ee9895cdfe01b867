// The backwards of kernels 12 and 11 (see ../fused_gmp_stream.py), with the
// forward recomputed in the kernel: the persistent tile walk of
// edge_bwd_tiles.cuh with the streamed front (kernel 12's adds the receiver
// row xj of each slot in its chunk's block), then grad_sum_kernel over its
// G blocks' weight-gradient partials. Kernel 12's dxj is the receiver
// gather of row_gather.cuh (`recv_gather_kernel`) over dzi and the
// level's receiver lists (`row_ptr`, `row_slots`, `row_long`: exactly the
// slots with a receiver in their chunk's block, the last block's pad slots
// on row n_pad − 1, as the TPU kernel's one-hot counts them), in list
// order. Each has its own kernel name, so the profiler and the launch
// counters tell them apart from kernel 5. A batch over the one level (src
// and dsrc [B][E_pad][C], xj, g and dxj [B][n_pad][C]) is one launch of
// each: the walk over the B·T tiles in its ranges, each sample's src and
// dsrc moving by e_stride = E_pad·C elements and its xj and g by x_stride
// = n_pad·C, still G partials (the weight gradients summed over the
// batch), and the dxj gather with the batch as its grid's y extent.
#include "edge_bwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::MIN_BLOCKS)
fused_edge_phase_bwd_kernel(
    const T* __restrict__ zi, const T* __restrict__ xj,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, float* __restrict__ gpart,
    T* __restrict__ dzi, int n_batch, size_t x_stride, size_t e_stride) {
  tiles::edge_bwd_tiles<T, BF16, Front::kStream>(
      nullptr, zi, xj, nullptr, W, B, WT, g, n_layers, nullptr, nullptr,
      receivers, chunk_block, n_tiles, e_pad, edge_block, 0, gpart, dzi,
      nullptr, nullptr, nullptr, 0, n_batch, x_stride, e_stride);
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::MIN_BLOCKS)
fused_edge_mlp_aggregate_bwd_kernel(
    const T* __restrict__ pre, const float* __restrict__ W,
    const float* __restrict__ B, const float* __restrict__ WT,
    const float* __restrict__ g, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, float* __restrict__ gpart,
    T* __restrict__ dpre, int n_batch, size_t x_stride, size_t e_stride) {
  tiles::edge_bwd_tiles<T, BF16, Front::kStream>(
      nullptr, pre, nullptr, nullptr, W, B, WT, g, n_layers, nullptr,
      nullptr, receivers, chunk_block, n_tiles, e_pad, edge_block, 0, gpart,
      dpre, nullptr, nullptr, nullptr, 0, n_batch, x_stride, e_stride);
}


// Kernel 12's backward: the tile walk over `grid` blocks, the dxj gather,
// the partials' sum.
template <typename T, bool BF16>
int launch_v2(const void* zi, const void* xj, const void* W, const void* B,
              const void* WT, const void* g, const void* receivers,
              const void* chunk_block, const void* row_ptr,
              const void* row_slots, const void* long_rows, int n_layers,
              int grid, int n_tiles, int e_pad, int edge_block, int n_rows,
              int n_long, int piece, int n_batch, void* gpart, void* dzi,
              void* dxj, void* grads, void* stream) {
  if (edge_block % tiles::TR || n_tiles * tiles::TR != e_pad ||
      n_layers < 1 || n_layers > tiles::MAX_LAYERS || n_batch < 1 ||
      n_batch > MAX_BATCH || (long long)n_tiles * n_batch > INT_MAX ||
      grid < 1 || grid > n_tiles * n_batch || xj == nullptr || n_rows < 1 ||
      n_long < 0 || piece < 1)
    return (int)cudaErrorInvalidValue;
  const size_t x_stride = (size_t)n_rows * C, e_stride = (size_t)e_pad * C;
  auto kernel = fused_edge_phase_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles::smem_bytes(tiles::MAX_LAYERS, Front::kStream));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = tiles::smem_bytes(n_layers, Front::kStream);
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const T*)zi, (const T*)xj, (const float*)W, (const float*)B,
      (const float*)WT, (const float*)g, n_layers, (const int*)receivers,
      (const int*)chunk_block, n_tiles, e_pad, edge_block, (float*)gpart,
      (T*)dzi, n_batch, x_stride, e_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16><<<gather_grid(n_rows, n_long, n_batch),
                                THREADS, 0, s>>>(
      (const T*)dzi, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)dxj, e_stride, x_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, grid,
                              tiles::grad_size(n_layers, Front::kStream),
                              (float*)grads, s);
}

template <typename T, bool BF16>
int blocks_per_sm_v2(int n_layers, int* out) {
  return (int)tiles::walk_blocks_per_sm(fused_edge_phase_bwd_kernel<T, BF16>,
                                        n_layers, Front::kStream, out);
}

template <typename T, bool BF16>
int blocks_per_sm_v1(int n_layers, int* out) {
  return (int)tiles::walk_blocks_per_sm(
      fused_edge_mlp_aggregate_bwd_kernel<T, BF16>, n_layers, Front::kStream,
      out);
}

// Kernel 11's backward: the tile walk over `grid` blocks, the partials' sum.
template <typename T, bool BF16>
int launch_v1(const void* pre, const void* W, const void* B, const void* WT,
              const void* g, const void* receivers, const void* chunk_block,
              int n_layers, int grid, int n_tiles, int e_pad, int edge_block,
              int n_rows, int n_batch, void* gpart, void* dpre, void* grads,
              void* stream) {
  if (edge_block % tiles::TR || n_tiles * tiles::TR != e_pad ||
      n_layers < 1 || n_layers > tiles::MAX_LAYERS || n_batch < 1 ||
      n_batch > MAX_BATCH || (long long)n_tiles * n_batch > INT_MAX ||
      grid < 1 || grid > n_tiles * n_batch || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_mlp_aggregate_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles::smem_bytes(tiles::MAX_LAYERS, Front::kStream));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = tiles::smem_bytes(n_layers, Front::kStream);
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const T*)pre, (const float*)W, (const float*)B, (const float*)WT,
      (const float*)g, n_layers, (const int*)receivers,
      (const int*)chunk_block, n_tiles, e_pad, edge_block, (float*)gpart,
      (T*)dpre, n_batch, (size_t)n_rows * C, (size_t)e_pad * C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, grid,
                              tiles::grad_size(n_layers, Front::kStream),
                              (float*)grads, s);
}

}  // namespace

#define FUSED_EDGE_PHASE_BWD(NAME, T, BF16)                                   \
  extern "C" int NAME##_blocks_per_sm(int n_layers, int* out) {              \
    return blocks_per_sm_v2<T, BF16>(n_layers, out);                          \
  }                                                                           \
  extern "C" int NAME(const void* zi, const void* xj, const void* W,         \
                      const void* B, const void* WT, const void* g,          \
                      const void* receivers, const void* chunk_block,        \
                      const void* row_ptr, const void* row_slots,            \
                      const void* long_rows, int n_layers, int grid,         \
                      int n_tiles, int e_pad, int edge_block, int n_rows,    \
                      int n_long, int piece, int n_batch, void* gpart,       \
                      void* dzi, void* dxj, void* grads, void* stream) {     \
    return launch_v2<T, BF16>(zi, xj, W, B, WT, g, receivers, chunk_block,   \
                              row_ptr, row_slots, long_rows, n_layers, grid, \
                              n_tiles, e_pad, edge_block, n_rows, n_long,    \
                              piece, n_batch, gpart, dzi, dxj, grads,        \
                              stream);                                       \
  }

#define FUSED_EDGE_MLP_AGGREGATE_BWD(NAME, T, BF16)                           \
  extern "C" int NAME##_blocks_per_sm(int n_layers, int* out) {              \
    return blocks_per_sm_v1<T, BF16>(n_layers, out);                          \
  }                                                                           \
  extern "C" int NAME(const void* pre, const void* W, const void* B,         \
                      const void* WT, const void* g, const void* receivers,  \
                      const void* chunk_block, int n_layers, int grid,       \
                      int n_tiles, int e_pad, int edge_block, int n_rows,    \
                      int n_batch, void* gpart, void* dpre, void* grads,     \
                      void* stream) {                                        \
    return launch_v1<T, BF16>(pre, W, B, WT, g, receivers, chunk_block,      \
                              n_layers, grid, n_tiles, e_pad, edge_block,    \
                              n_rows, n_batch, gpart, dpre, grads, stream);  \
  }

FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_f32, float, false)
FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_bf16, __nv_bfloat16, true)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_f32, float, false)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_bf16,
                             __nv_bfloat16, true)
