// Kernel 14: the K-way interleaved windowed fused GMP edge phase (see
// ../fused_gmp_k.py), kernel 4's function:
//
//   out[n] = Σ_{in-window e: recv(e)=n}
//            LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))
//
// Kernel 4's forward tile walk (edge_fwd_tiles.cuh: a persistent grid of G
// blocks over the level's 64-slot tiles, dead tiles skipped, each live
// slot's message stored into msg), then recv_gather_kernel, the row-ordered
// gather of row_gather.cuh, which sums out from msg over the receiver lists
// (`win_row_ptr`, `win_row_slots`, `win_long`: exactly the live slots). No
// shared-memory output block, no per-group part, no block sum. K orders
// nothing here: on the TPU it only interleaved the sums of K chunks. A
// step that stacked K tiles on 512 threads (each staged weight slab
// serving K tiles, one block per SM) read slower than one tile a step at
// two blocks per SM at the 5k airfoil's gated levels (PERF.md). Its own
// kernel name, so the profiler tells it apart from kernel 4.
#include "edge_fwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::FWD_MIN_BLOCKS)
fused_edge_phase_win_k_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window, T* __restrict__ msg) {
  tiles::edge_fwd_tiles<T, BF16, Front::kWin>(
      fiber_t, xwi, xj, wf8, W, B, n_layers, send_win, win_base, receivers,
      chunk_block, n_tiles, e_pad, edge_block, window, msg);
}

template <typename T, bool BF16>
int blocks_per_sm(int* out) {
  return (int)tiles::fwd_blocks_per_sm(fused_edge_phase_win_k_kernel<T, BF16>,
                                       Front::kWin, out);
}

template <typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* wf8, const void* W, const void* B,
           const void* send_win, const void* win_base, const void* receivers,
           const void* chunk_block, const void* row_ptr,
           const void* row_slots, const void* long_rows, int n_layers,
           int grid, int n_tiles, int e_pad, int edge_block, int window,
           int n_rows, int n_long, int piece, int n_batch, void* msg,
           void* out, void* stream) {
  if (edge_block % tiles::TR || n_tiles * tiles::TR != e_pad ||
      n_layers < 1 || grid < 1 || grid > n_tiles || n_rows < 1 ||
      n_long < 0 || piece < 1 || n_batch != 1)  // one sample only
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_edge_phase_win_k_kernel<T, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tiles::fwd_smem_bytes(Front::kWin));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = tiles::fwd_smem_bytes(Front::kWin);
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const float*)wf8,
      (const float*)W, (const float*)B, n_layers, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      n_tiles, e_pad, edge_block, window, (T*)msg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16><<<gather_blocks(n_rows, n_long), THREADS, 0,
                                s>>>(
      (const T*)msg, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)out, 0, 0);  // B = 1
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_K(NAME, T, BF16)                                 \
  extern "C" int NAME##_blocks_per_sm(int n_layers, int* out) {              \
    (void)n_layers; /* the walk's shared memory is the same at any depth */  \
    return blocks_per_sm<T, BF16>(out);                                       \
  }                                                                           \
  extern "C" int NAME(const void* fiber_t, const void* xwi, const void* xj,  \
                      const void* wf8, const void* W, const void* B,         \
                      const void* send_win, const void* win_base,            \
                      const void* receivers, const void* chunk_block,        \
                      const void* row_ptr, const void* row_slots,            \
                      const void* long_rows, int n_layers, int grid,         \
                      int n_tiles, int e_pad, int edge_block, int window,    \
                      int n_rows, int n_long, int piece, int n_batch,        \
                      void* msg, void* out, void* stream) {                  \
    return launch<T, BF16>(fiber_t, xwi, xj, wf8, W, B, send_win, win_base,  \
                           receivers, chunk_block, row_ptr, row_slots,       \
                           long_rows, n_layers, grid, n_tiles, e_pad,        \
                           edge_block, window, n_rows, n_long, piece,        \
                           n_batch, msg, out, stream);                       \
  }

FUSED_EDGE_PHASE_WIN_K(fused_edge_phase_win_k_f32, float, false)
FUSED_EDGE_PHASE_WIN_K(fused_edge_phase_win_k_bf16, __nv_bfloat16, true)
