// Kernels 12 and 11: the fused GMP edge phase on a streamed first layer
// (see ../fused_gmp_stream.py).
//
//   kernel 12: out[n] = Σ_{e: recv(e)=n} LN(tail(relu(zi[e] + xj[recv_e])))
//   kernel 11: out[n] = Σ_{e: recv(e)=n} LN(tail(relu(pre[e])))
//
// over the slots whose receiver lies in their chunk's 128-row output block.
// The chunk walk (edge_phase.cuh) with the streamed front, then
// block_sum_kernel over the parts. Each has its own kernel name, so the
// profiler and the launch counters tell them apart from kernel 4.
#include "block_sum.cuh"
#include "edge_phase.cuh"

using namespace bsms;

namespace {

constexpr size_t SMEM_BYTES = edge_fwd_smem_bytes();

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_phase_kernel(const T* __restrict__ zi, const T* __restrict__ xj,
                        const float* __restrict__ W,
                        const float* __restrict__ B, int n_layers,
                        const int* __restrict__ receivers,
                        const int* __restrict__ chunk_block, int edge_block,
                        float* __restrict__ part) {
  edge_phase_fwd_chunk<T, BF16>(zi, xj, W, B, n_layers, receivers,
                                chunk_block, edge_block, part);
}

// xj is always null here: the signature is kernel 12's, so that one launcher
// takes both.
template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_mlp_aggregate_kernel(const T* __restrict__ pre,
                                const T* __restrict__ xj,
                                const float* __restrict__ W,
                                const float* __restrict__ B, int n_layers,
                                const int* __restrict__ receivers,
                                const int* __restrict__ chunk_block,
                                int edge_block, float* __restrict__ part) {
  edge_phase_fwd_chunk<T, BF16>(pre, nullptr, W, B, n_layers, receivers,
                                chunk_block, edge_block, part);
}

// V2: kernel 12 (src = zi, with xj), else kernel 11 (src = pre, xj null).
template <typename T, bool BF16, bool V2>
int launch(const void* src, const void* xj, const void* W, const void* B,
           const void* receivers, const void* chunk_block,
           const void* chunk_ptr, int n_layers, int n_chunks, int n_blocks,
           int e_pad, int edge_block, void* part, void* out, void* stream) {
  if (edge_block % TILE || e_pad != n_chunks * edge_block ||
      (xj != nullptr) != V2)
    return (int)cudaErrorInvalidValue;
  auto kernel = V2 ? fused_edge_phase_kernel<T, BF16>
                   : fused_edge_mlp_aggregate_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_chunks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const T*)src, (const T*)xj, (const float*)W, (const float*)B, n_layers,
      (const int*)receivers, (const int*)chunk_block, edge_block,
      (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, (cudaStream_t)stream);
}

}  // namespace

#define FUSED_EDGE_PHASE(NAME, T, BF16)                                       \
  extern "C" int NAME(const void* zi, const void* xj, const void* W,         \
                      const void* B, const void* receivers,                  \
                      const void* chunk_block, const void* chunk_ptr,        \
                      int n_layers, int n_chunks, int n_blocks, int e_pad,   \
                      int edge_block, void* part, void* out, void* stream) { \
    return launch<T, BF16, true>(zi, xj, W, B, receivers, chunk_block,       \
                                 chunk_ptr, n_layers, n_chunks, n_blocks,    \
                                 e_pad, edge_block, part, out, stream);      \
  }

#define FUSED_EDGE_MLP_AGGREGATE(NAME, T, BF16)                               \
  extern "C" int NAME(const void* pre, const void* W, const void* B,         \
                      const void* receivers, const void* chunk_block,        \
                      const void* chunk_ptr, int n_layers, int n_chunks,     \
                      int n_blocks, int e_pad, int edge_block, void* part,   \
                      void* out, void* stream) {                             \
    return launch<T, BF16, false>(pre, nullptr, W, B, receivers,             \
                                  chunk_block, chunk_ptr, n_layers,          \
                                  n_chunks, n_blocks, e_pad, edge_block,     \
                                  part, out, stream);                        \
  }

FUSED_EDGE_PHASE(fused_edge_phase_f32, float, false)
FUSED_EDGE_PHASE(fused_edge_phase_bf16, __nv_bfloat16, true)
FUSED_EDGE_MLP_AGGREGATE(fused_edge_mlp_aggregate_f32, float, false)
FUSED_EDGE_MLP_AGGREGATE(fused_edge_mlp_aggregate_bf16, __nv_bfloat16, true)
