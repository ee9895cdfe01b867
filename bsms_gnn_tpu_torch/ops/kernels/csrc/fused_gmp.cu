// Kernel 4: the windowed fused GMP edge phase (see ../fused_gmp.py).
//
//   out[n] = Σ_{in-window e: recv(e)=n}
//            LN(tail(relu(fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e])))
//
// The persistent forward tile walk of edge_fwd_tiles.cuh (each live slot's
// message into msg), then recv_gather_kernel, the row-ordered gather of
// row_gather.cuh, which sums out from msg over the receiver lists
// (`win_row_ptr`, `win_row_slots`, `win_long`: exactly the live slots).
// A batch over the one level (xwi, xj [B][n_pad][C]; msg [B][E_pad][C],
// out [B][n_pad][C]) is one launch of each: the walk over B·T tiles, the
// gather with the batch as its grid's y extent.
#include "edge_fwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::FWD_MIN_BLOCKS)
fused_edge_phase_win_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window, T* __restrict__ msg,
    int n_batch, size_t x_stride, size_t e_stride) {
  tiles::edge_fwd_tiles<T, BF16, Front::kWin>(
      fiber_t, xwi, xj, wf8, W, B, n_layers, send_win, win_base, receivers,
      chunk_block, n_tiles, e_pad, edge_block, window, msg, nullptr, nullptr,
      nullptr, 0, n_batch, x_stride, e_stride);
}

template <typename T, bool BF16>
int blocks_per_sm(int* out) {
  return (int)tiles::fwd_blocks_per_sm(fused_edge_phase_win_kernel<T, BF16>,
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
      n_layers < 1 || n_batch < 1 || n_batch > MAX_BATCH ||
      (long long)n_tiles * n_batch > INT_MAX || grid < 1 ||
      grid > n_tiles * n_batch || n_rows < 1 || n_long < 0 || piece < 1)
    return (int)cudaErrorInvalidValue;
  const size_t x_stride = (size_t)n_rows * C, e_stride = (size_t)e_pad * C;
  auto kernel = fused_edge_phase_win_kernel<T, BF16>;
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
      n_tiles, e_pad, edge_block, window, (T*)msg, n_batch, x_stride,
      e_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16><<<gather_grid(n_rows, n_long, n_batch),
                                THREADS, 0, s>>>(
      (const T*)msg, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)out, e_stride, x_stride);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN(NAME, T, BF16)                                   \
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

FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_f32, float, false)
FUSED_EDGE_PHASE_WIN(fused_edge_phase_win_bf16, __nv_bfloat16, true)
