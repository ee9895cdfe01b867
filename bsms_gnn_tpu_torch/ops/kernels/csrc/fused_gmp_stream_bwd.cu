// The backwards of kernels 12 and 11 (see ../fused_gmp_stream.py), with the
// forward recomputed in the kernel. Kernel 12's: the chunk walk of
// edge_phase_bwd.cuh with the streamed front, block_sum_kernel over the dxj
// parts, and grad_sum_kernel over the per-chunk weight-gradient partials
// (dW, db). Kernel 11's (no receiver rows, so no dxj): the persistent tile
// walk of edge_bwd_tiles.cuh with the streamed front, then
// grad_sum_kernel over its G blocks' partials. Each has its own kernel
// name, so the profiler and the launch counters tell them apart from kernel
// 5.
#include "block_sum.cuh"
#include "edge_bwd_tiles.cuh"
#include "edge_phase_bwd.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_phase_bwd_kernel(
    const T* __restrict__ zi, const T* __restrict__ xj,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, float* __restrict__ part,
    float* __restrict__ gpart, T* __restrict__ dzi) {
  edge_phase_bwd_chunk<T, BF16, Front::kStream>(
      nullptr, zi, xj, nullptr, W, B, WT, g, n_layers, nullptr, nullptr,
      receivers, chunk_block, e_pad, edge_block, 0, part, gpart, dzi);
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::MIN_BLOCKS)
fused_edge_mlp_aggregate_bwd_kernel(
    const T* __restrict__ pre, const float* __restrict__ W,
    const float* __restrict__ B, const float* __restrict__ WT,
    const float* __restrict__ g, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, float* __restrict__ gpart,
    T* __restrict__ dpre) {
  tiles::edge_bwd_tiles<T, BF16, Front::kStream>(
      nullptr, pre, nullptr, nullptr, W, B, WT, g, n_layers, nullptr,
      nullptr, receivers, chunk_block, n_tiles, e_pad, edge_block, 0, gpart,
      dpre);
}

// Kernel 12's backward: the chunk walk, the dxj parts' sum, the partials'.
template <typename T, bool BF16>
int launch_v2(const void* zi, const void* xj, const void* W, const void* B,
              const void* WT, const void* g, const void* receivers,
              const void* chunk_block, const void* chunk_ptr, int n_layers,
              int n_chunks, int n_blocks, int e_pad, int edge_block,
              void* part, void* gpart, void* dzi, void* dxj, void* grads,
              void* stream) {
  if (edge_block % TILE || n_layers < 1 || n_layers > MAX_BWD_LAYERS ||
      xj == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)edge_bwd_smem_bytes(MAX_BWD_LAYERS));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_chunks, THREADS, edge_bwd_smem_bytes(n_layers), s>>>(
      (const T*)zi, (const T*)xj, (const float*)W, (const float*)B,
      (const float*)WT, (const float*)g, n_layers, (const int*)receivers,
      (const int*)chunk_block, e_pad, edge_block, (float*)part,
      (float*)gpart, (T*)dzi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_block_sum((const float*)part, (const int*)chunk_ptr,
                         (float*)dxj, n_blocks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, n_chunks,
                              edge_grad_size<Front::kStream>(n_layers),
                              (float*)grads, s);
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
              void* gpart, void* dpre, void* grads, void* stream) {
  if (edge_block % tiles::TR || n_tiles * tiles::TR != e_pad ||
      n_layers < 1 || n_layers > tiles::MAX_LAYERS || grid < 1 ||
      grid > n_tiles)
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
      (T*)dpre);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, grid,
                              tiles::grad_size(n_layers, Front::kStream),
                              (float*)grads, s);
}

}  // namespace

#define FUSED_EDGE_PHASE_BWD(NAME, T, BF16)                                   \
  extern "C" int NAME(const void* zi, const void* xj, const void* W,         \
                      const void* B, const void* WT, const void* g,          \
                      const void* receivers, const void* chunk_block,        \
                      const void* chunk_ptr, int n_layers, int n_chunks,     \
                      int n_blocks, int e_pad, int edge_block, void* part,   \
                      void* gpart, void* dzi, void* dxj, void* grads,        \
                      void* stream) {                                        \
    return launch_v2<T, BF16>(zi, xj, W, B, WT, g, receivers, chunk_block,   \
                              chunk_ptr, n_layers, n_chunks, n_blocks,       \
                              e_pad, edge_block, part, gpart, dzi, dxj,      \
                              grads, stream);                                \
  }

#define FUSED_EDGE_MLP_AGGREGATE_BWD(NAME, T, BF16)                           \
  extern "C" int NAME##_blocks_per_sm(int n_layers, int* out) {              \
    return blocks_per_sm_v1<T, BF16>(n_layers, out);                          \
  }                                                                           \
  extern "C" int NAME(const void* pre, const void* W, const void* B,         \
                      const void* WT, const void* g, const void* receivers,  \
                      const void* chunk_block, int n_layers, int grid,       \
                      int n_tiles, int e_pad, int edge_block, void* gpart,   \
                      void* dpre, void* grads, void* stream) {               \
    return launch_v1<T, BF16>(pre, W, B, WT, g, receivers, chunk_block,      \
                              n_layers, grid, n_tiles, e_pad, edge_block,    \
                              gpart, dpre, grads, stream);                   \
  }

FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_f32, float, false)
FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_bf16, __nv_bfloat16, true)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_f32, float, false)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_bf16,
                             __nv_bfloat16, true)
