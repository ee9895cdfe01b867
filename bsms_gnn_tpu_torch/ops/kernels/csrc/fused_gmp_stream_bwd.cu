// The backwards of kernels 12 and 11 (see ../fused_gmp_stream.py), with the
// forward recomputed in the kernel: the chunk walk of edge_phase_bwd.cuh
// with the streamed front, then, for kernel 12, block_sum_kernel over the
// dxj parts, and grad_sum_kernel over the weight-gradient partials (dW, db).
// Kernel 11's backward has no receiver rows and so no dxj. Each has its own
// kernel name, so the profiler and the launch counters tell them apart from
// kernel 5.
#include "block_sum.cuh"
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
      nullptr, zi, xj, nullptr, nullptr, nullptr, nullptr, 0, W, B, WT, g,
      n_layers, nullptr, nullptr, receivers, chunk_block, e_pad, edge_block,
      0, part, gpart, dzi);
}

// xj and part are always null here: the signature is kernel 12's backward's,
// so that one launcher takes both.
template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_mlp_aggregate_bwd_kernel(
    const T* __restrict__ pre, const T* __restrict__ xj,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, float* __restrict__ part,
    float* __restrict__ gpart, T* __restrict__ dpre) {
  edge_phase_bwd_chunk<T, BF16, Front::kStream>(
      nullptr, pre, nullptr, nullptr, nullptr, nullptr, nullptr, 0, W, B, WT,
      g, n_layers, nullptr, nullptr, receivers, chunk_block, e_pad,
      edge_block, 0, nullptr, gpart, dpre);
}

// V2: kernel 12's backward (with xj, dxj summed over `part`), else kernel
// 11's (xj, part, chunk_ptr and dxj null).
template <typename T, bool BF16, bool V2>
int launch(const void* src, const void* xj, const void* W, const void* B,
           const void* WT, const void* g, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_layers,
           int n_chunks, int n_blocks, int e_pad, int edge_block, void* part,
           void* gpart, void* dsrc, void* dxj, void* grads, void* stream) {
  if (edge_block % TILE || n_layers < 1 || n_layers > MAX_BWD_LAYERS ||
      (xj != nullptr) != V2)
    return (int)cudaErrorInvalidValue;
  auto kernel = V2 ? fused_edge_phase_bwd_kernel<T, BF16>
                   : fused_edge_mlp_aggregate_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)edge_bwd_smem_bytes<false>(MAX_BWD_LAYERS));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_chunks, THREADS, edge_bwd_smem_bytes<false>(n_layers), s>>>(
      (const T*)src, (const T*)xj, (const float*)W, (const float*)B,
      (const float*)WT, (const float*)g, n_layers, (const int*)receivers,
      (const int*)chunk_block, e_pad, edge_block, (float*)part,
      (float*)gpart, (T*)dsrc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (V2) {
    err = launch_block_sum((const float*)part, (const int*)chunk_ptr,
                           (float*)dxj, n_blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_grad_sum((const float*)gpart, n_chunks,
                              edge_grad_size<Front::kStream>(n_layers, 0),
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
    return launch<T, BF16, true>(zi, xj, W, B, WT, g, receivers,             \
                                 chunk_block, chunk_ptr, n_layers, n_chunks, \
                                 n_blocks, e_pad, edge_block, part, gpart,   \
                                 dzi, dxj, grads, stream);                   \
  }

#define FUSED_EDGE_MLP_AGGREGATE_BWD(NAME, T, BF16)                           \
  extern "C" int NAME(const void* pre, const void* W, const void* B,         \
                      const void* WT, const void* g, const void* receivers,  \
                      const void* chunk_block, int n_layers, int n_chunks,   \
                      int e_pad, int edge_block, void* gpart, void* dpre,    \
                      void* grads, void* stream) {                           \
    return launch<T, BF16, false>(pre, nullptr, W, B, WT, g, receivers,      \
                                  chunk_block, nullptr, n_layers, n_chunks,  \
                                  0, e_pad, edge_block, nullptr, gpart,      \
                                  dpre, nullptr, grads, stream);             \
  }

FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_f32, float, false)
FUSED_EDGE_PHASE_BWD(fused_edge_phase_bwd_bf16, __nv_bfloat16, true)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_f32, float, false)
FUSED_EDGE_MLP_AGGREGATE_BWD(fused_edge_mlp_aggregate_bwd_bf16,
                             __nv_bfloat16, true)
