// Kernel 4: the windowed fused GMP edge phase (see ../fused_gmp.py).
//
//   out[n] = Σ_{in-window e: recv(e)=n}
//            LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))
//
// The chunk walk (edge_phase.cuh) without the dynamic fiber, then
// block_sum_kernel over the parts.
#include "block_sum.cuh"
#include "edge_phase.cuh"

using namespace bsms;

namespace {

constexpr size_t SMEM_BYTES = edge_fwd_smem_bytes<false>();

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_edge_phase_win_kernel(const float* __restrict__ fiber_t,
                            const T* __restrict__ xwi,
                            const T* __restrict__ xj,
                            const float* __restrict__ wf8,
                            const float* __restrict__ W,
                            const float* __restrict__ B, int n_layers,
                            const int* __restrict__ send_win,
                            const int* __restrict__ win_base,
                            const int* __restrict__ receivers,
                            const int* __restrict__ chunk_block, int e_pad,
                            int edge_block, int window,
                            float* __restrict__ part) {
  edge_phase_fwd_chunk<T, BF16, false>(
      fiber_t, xwi, xj, nullptr, wf8, nullptr, nullptr, 0, W, B, n_layers,
      send_win, win_base, receivers, chunk_block, e_pad, edge_block, window,
      part);
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B,
           const void* send_win, const void* win_base, const void* receivers,
           const void* chunk_block, const void* chunk_ptr, int n_layers,
           int n_chunks, int n_blocks, int e_pad, int edge_block, int window,
           void* part, void* out, void* stream) {
  if (edge_block % TILE) return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_win_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_chunks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, n_layers, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      e_pad, edge_block, window, (float*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_block_sum((const float*)part, (const int*)chunk_ptr,
                               (float*)out, n_blocks, (cudaStream_t)stream);
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN(NAME, T, BF16)                                   \
  extern "C" int NAME(const void* fiber_t, const void* xwi, const void* xj,  \
                      const void* wf8, const void* W, const void* B,         \
                      const void* send_win, const void* win_base,            \
                      const void* receivers, const void* chunk_block,        \
                      const void* chunk_ptr, int n_layers, int n_chunks,     \
                      int n_blocks, int e_pad, int edge_block, int window,   \
                      void* part, void* out, void* stream) {                 \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, send_win, win_base,  \
                           receivers, chunk_block, chunk_ptr, n_layers,      \
                           n_chunks, n_blocks, e_pad, edge_block, window,    \
                           part, out, stream);                               \
  }

FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_f32, float, false)
FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_bf16, __nv_bfloat16, true)
