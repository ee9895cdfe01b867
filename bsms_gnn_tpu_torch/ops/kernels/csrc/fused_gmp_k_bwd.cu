// Kernel 14's backward (see ../fused_gmp_k.py), with the forward recomputed
// in the kernel: kernel 5's function. K orders nothing here: on the TPU it
// only interleaved the sums of K chunks. Kernel 5's persistent tile walk
// (edge_bwd_tiles.cuh with the windowed front: G blocks over the level's
// 64-slot tiles, dead tiles writing zero dpre rows, one weight-gradient
// partial [dW | db | dwf8] per block), then recv_gather_kernel, the
// row-ordered gather of row_gather.cuh that sums dxj from dpre over the
// receiver lists (`win_row_ptr`, `win_row_slots`, `win_long`: the slots
// the walk gives a cotangent), and grad_sum_kernel over the partials in
// block order. Its own kernel name, so the profiler and the launch
// counters tell it apart from kernel 5.
#include "edge_bwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::MIN_BLOCKS)
fused_edge_phase_win_k_bwd_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window,
    float* __restrict__ gpart, T* __restrict__ dpre) {
  tiles::edge_bwd_tiles<T, BF16, Front::kWin>(
      fiber_t, xwi, xj, wf8, W, B, WT, g, n_layers, send_win, win_base,
      receivers, chunk_block, n_tiles, e_pad, edge_block, window, gpart,
      dpre);
}

template <typename T, bool BF16>
int blocks_per_sm(int n_layers, int* out) {
  return (int)tiles::walk_blocks_per_sm(
      fused_edge_phase_win_k_bwd_kernel<T, BF16>, n_layers, Front::kWin,
      out);
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B, const void* WT,
           const void* g, const void* send_win, const void* win_base,
           const void* receivers, const void* chunk_block,
           const void* row_ptr, const void* row_slots, const void* long_rows,
           int n_layers, int grid, int n_tiles, int e_pad, int edge_block,
           int window, int n_rows, int n_long, int piece, int n_batch,
           void* gpart, void* dpre, void* dxj, void* grads, void* stream) {
  if (edge_block % tiles::TR || n_tiles * tiles::TR != e_pad ||
      n_layers < 1 || n_layers > tiles::MAX_LAYERS || grid < 1 ||
      grid > n_tiles || n_rows < 1 || n_long < 0 || piece < 1 ||
      n_batch != 1)  // one sample only
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_win_k_bwd_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles::smem_bytes(tiles::MAX_LAYERS, Front::kWin));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = tiles::smem_bytes(n_layers, Front::kWin);
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, (const float*)WT, (const float*)g,
      n_layers, (const int*)send_win, (const int*)win_base,
      (const int*)receivers, (const int*)chunk_block, n_tiles, e_pad,
      edge_block, window, (float*)gpart, (T*)dpre);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16><<<gather_blocks(n_rows, n_long), THREADS, 0,
                                s>>>(
      (const T*)dpre, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)dxj, 0, 0);  // B = 1
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_grad_sum((const float*)gpart, grid,
                              tiles::grad_size(n_layers, Front::kWin),
                              (float*)grads, s);
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_K_BWD(NAME, T, BF16)                             \
  extern "C" int NAME##_blocks_per_sm(int n_layers, int* out) {              \
    return blocks_per_sm<T, BF16>(n_layers, out);                             \
  }                                                                           \
  extern "C" int NAME(                                                        \
      const void* fiber_t, const void* xwi, const void* xj, const void* wf8,  \
      const void* W, const void* B, const void* WT, const void* g,            \
      const void* send_win, const void* win_base, const void* receivers,      \
      const void* chunk_block, const void* row_ptr, const void* row_slots,    \
      const void* long_rows, int n_layers, int grid, int n_tiles, int e_pad,  \
      int edge_block, int window, int n_rows, int n_long, int piece,          \
      int n_batch, void* gpart, void* dpre, void* dxj, void* grads,           \
      void* stream) {                                                         \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, WT, g, send_win,      \
                           win_base, receivers, chunk_block, row_ptr,         \
                           row_slots, long_rows, n_layers, grid, n_tiles,     \
                           e_pad, edge_block, window, n_rows, n_long, piece,  \
                           n_batch, gpart, dpre, dxj, grads, stream);         \
  }

FUSED_EDGE_PHASE_WIN_K_BWD(fused_edge_phase_win_k_bwd_f32, float, false)
FUSED_EDGE_PHASE_WIN_K_BWD(fused_edge_phase_win_k_bwd_bf16, __nv_bfloat16,
                           true)
