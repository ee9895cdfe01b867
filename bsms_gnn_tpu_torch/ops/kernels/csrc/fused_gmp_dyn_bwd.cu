// Kernel 13's backward: the windowed fused GMP edge phase with a dynamic
// world-space fiber (see ../fused_gmp_dyn.py), with the forward recomputed
// in the kernel. Kernel 5's chunk walk (edge_phase_bwd.cuh) with the
// dynamic fiber, which adds dwf_dyn = Δᵀ·dpre and dwf_nrm = Σ ‖Δ‖·dpre to
// each chunk's weight-gradient partial; then block_sum_kernel over the dxj
// parts and grad_sum_kernel over the partials (dW, db, dwf8, dwf_dyn,
// dwf_nrm). No world-position cotangent: the positions are stop-gradient.
// Its own kernel name, so the profiler and the launch counters tell it
// apart from kernel 5.
#include "block_sum.cuh"
#include "edge_phase_bwd.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_phase_win_dyn_bwd_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const T* __restrict__ pos,
    const float* __restrict__ wf8, const float* __restrict__ wfd,
    const float* __restrict__ wfn, int wd, const float* __restrict__ W,
    const float* __restrict__ B, const float* __restrict__ WT,
    const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int edge_block, int window, float* __restrict__ part,
    float* __restrict__ gpart, T* __restrict__ dpre) {
  edge_phase_bwd_chunk<T, BF16, true>(
      fiber_t, xwi, xj, pos, wf8, wfd, wfn, wd, W, B, WT, g, n_layers,
      send_win, win_base, receivers, chunk_block, e_pad, edge_block, window,
      part, gpart, dpre);
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* pos, const void* wf8, const void* wfd, const void* wfn,
           const void* W, const void* B, const void* WT, const void* g,
           const void* send_win, const void* win_base, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_layers,
           int wd, int n_chunks, int n_blocks, int e_pad, int edge_block,
           int window, void* part, void* gpart, void* dpre, void* dxj,
           void* grads, void* stream) {
  if (edge_block % TILE || n_layers < 1 || n_layers > MAX_BWD_LAYERS ||
      wd < 1 || wd > MAX_WD)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_win_dyn_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)edge_bwd_smem_bytes<true>(MAX_BWD_LAYERS));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_chunks, THREADS, edge_bwd_smem_bytes<true>(n_layers), s>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const T*)pos,
      (const float*)wf8, (const float*)wfd, (const float*)wfn, wd,
      (const float*)W, (const float*)B, (const float*)WT, (const float*)g,
      n_layers, (const int*)send_win, (const int*)win_base,
      (const int*)receivers, (const int*)chunk_block, e_pad, edge_block,
      window, (float*)part, (float*)gpart, (T*)dpre);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_block_sum((const float*)part, (const int*)chunk_ptr,
                         (float*)dxj, n_blocks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, n_chunks,
                              edge_grad_size(n_layers, wd), (float*)grads, s);
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_DYN_BWD(NAME, T, BF16)                           \
  extern "C" int NAME(                                                        \
      const void* fiber_t, const void* xwi, const void* xj, const void* pos,  \
      const void* wf8, const void* wfd, const void* wfn, const void* W,       \
      const void* B, const void* WT, const void* g, const void* send_win,     \
      const void* win_base, const void* receivers, const void* chunk_block,   \
      const void* chunk_ptr, int n_layers, int wd, int n_chunks,              \
      int n_blocks, int e_pad, int edge_block, int window, void* part,        \
      void* gpart, void* dpre, void* dxj, void* grads, void* stream) {        \
    return launch<T, BF16>(fiber_t, xwi, xj, pos, wf8, wfd, wfn, W, B, WT, g, \
                           send_win, win_base, receivers, chunk_block,        \
                           chunk_ptr, n_layers, wd, n_chunks, n_blocks,       \
                           e_pad, edge_block, window, part, gpart, dpre, dxj, \
                           grads, stream);                                    \
  }

FUSED_EDGE_PHASE_WIN_DYN_BWD(fused_edge_phase_win_dyn_bwd_f32, float, false)
FUSED_EDGE_PHASE_WIN_DYN_BWD(fused_edge_phase_win_dyn_bwd_bf16, __nv_bfloat16,
                             true)
