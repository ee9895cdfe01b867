// Kernel 13: the windowed fused GMP edge phase with a dynamic world-space
// fiber (see ../fused_gmp_dyn.py).
//
//   out[n] = Σ_{in-window e: recv(e)=n} LN(tail(relu(
//              fiber_t[:, e]ᵀ·wf8 + xwi[send_e] + xj[recv_e]
//              + Δ_e·wf_dyn + ‖Δ_e‖·wf_nrm)))
//   Δ_e = world[send_e] − world[recv_e]
//
// The persistent forward tile walk of edge_fwd_tiles.cuh with the kDyn
// front (each tile's slots take Δ and ‖Δ‖ from the [n_pad, wd] positions;
// wf_dyn and wf_nrm sit in shared memory beside wf8; each live slot's
// message into msg), then recv_gather_kernel, the row-ordered gather of
// row_gather.cuh, which sums out from msg over the receiver lists
// (`win_row_ptr`, `win_row_slots`, `win_long`: exactly the live slots, the
// ones kernel 13's backward gathers dxj over). No shared-memory output
// block, no per-chunk part, no block sum. Its own kernel name, so the
// profiler and the launch counters tell it apart from kernel 4. A batch
// over the one level (xwi, xj [B][n_pad][C], pos [B][n_pad][wd]; msg
// [B][E_pad][C], out [B][n_pad][C]) is one launch of each: the walk over
// B·T tiles, the gather with the batch as its grid's y extent. The latent
// width C is 128 (the walk's plan `Base`) or 256 (`WideFwd`: 32-slot
// tiles, each lane 4 columns of each 128-column half, the kDyn front's
// Δ·wf_dyn and ‖Δ‖·wf_nrm terms on both halves), chosen at launch; the
// gather then sums 128-column blocks on its grid's z index.
#include "edge_fwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

template <class P, typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::FWD_MIN_BLOCKS)
fused_edge_phase_win_dyn_kernel(
    const float* __restrict__ fiber_t, const T* __restrict__ xwi,
    const T* __restrict__ xj, const T* __restrict__ pos,
    const float* __restrict__ wf8, const float* __restrict__ wfd,
    const float* __restrict__ wfn, int wd, const float* __restrict__ W,
    const float* __restrict__ B, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window, T* __restrict__ msg,
    int n_batch, size_t x_stride, size_t e_stride, size_t p_stride) {
  tiles::edge_fwd_tiles<P, T, BF16, Front::kDyn>(
      fiber_t, xwi, xj, wf8, W, B, n_layers, send_win, win_base, receivers,
      chunk_block, n_tiles, e_pad, edge_block, window, msg, pos, wfd, wfn,
      wd, n_batch, x_stride, e_stride, p_stride);
}

template <typename T, bool BF16>
int blocks_per_sm(int width, int* out) {
  return tiles::with_fwd_plan<true>(width, [&](auto p) {
    using P = decltype(p);
    return (int)tiles::fwd_blocks_per_sm<P>(
        fused_edge_phase_win_dyn_kernel<P, T, BF16>, Front::kDyn, out);
  });
}

template <class P, typename T, bool BF16>
int launch(const void* fiber_t, const void* xwi, const void* xj,
           const void* pos, const void* wf8, const void* wfd, const void* wfn,
           const void* W, const void* B, const void* send_win,
           const void* win_base, const void* receivers,
           const void* chunk_block, const void* row_ptr,
           const void* row_slots, const void* long_rows, int n_layers,
           int wd, int grid, int n_tiles, int e_pad, int edge_block,
           int window, int n_rows, int n_long, int piece, int n_batch,
           void* msg, void* out, void* stream) {
  constexpr int C = P::C;
  if (edge_block % P::TR || n_tiles * P::TR != e_pad || n_layers < 1 ||
      wd < 1 || wd > MAX_WD || n_batch < 1 || n_batch > MAX_BATCH ||
      (long long)n_tiles * n_batch > INT_MAX || grid < 1 ||
      grid > n_tiles * n_batch || n_rows < 1 || n_long < 0 || piece < 1)
    return (int)cudaErrorInvalidValue;
  const size_t x_stride = (size_t)n_rows * C, e_stride = (size_t)e_pad * C,
               p_stride = (size_t)n_rows * wd;
  auto kernel = fused_edge_phase_win_dyn_kernel<P, T, BF16>;
  constexpr size_t smem = tiles::fwd_smem_bytes<P>(Front::kDyn);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const float*)fiber_t, (const T*)xwi, (const T*)xj, (const T*)pos,
      (const float*)wf8, (const float*)wfd, (const float*)wfn, wd,
      (const float*)W, (const float*)B, n_layers, (const int*)send_win,
      (const int*)win_base, (const int*)receivers, (const int*)chunk_block,
      n_tiles, e_pad, edge_block, window, (T*)msg, n_batch, x_stride,
      e_stride, p_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16, C><<<
      gather_grid(n_rows, n_long, n_batch, WARP_ROWS, P::V), THREADS, 0,
      s>>>((const T*)msg, (const int*)row_ptr, (const int*)row_slots,
           (const int*)long_rows, n_rows, piece, (float*)out, e_stride,
           x_stride);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_EDGE_PHASE_WIN_DYN(NAME, T, BF16)                               \
  extern "C" int NAME##_blocks_per_sm(int width, int n_layers, int* out) {   \
    (void)n_layers; /* the walk's shared memory is the same at any depth */  \
    return blocks_per_sm<T, BF16>(width, out);                                \
  }                                                                           \
  extern "C" int NAME(                                                        \
      const void* fiber_t, const void* xwi, const void* xj, const void* pos,  \
      const void* wf8, const void* wfd, const void* wfn, const void* W,       \
      const void* B, const void* send_win, const void* win_base,              \
      const void* receivers, const void* chunk_block, const void* row_ptr,    \
      const void* row_slots, const void* long_rows, int width, int n_layers,  \
      int wd, int grid, int n_tiles, int e_pad, int edge_block, int window,   \
      int n_rows, int n_long, int piece, int n_batch, void* msg, void* out,  \
      void* stream) {                                                         \
    return tiles::with_fwd_plan<true>(width, [&](auto p) {                    \
      return launch<decltype(p), T, BF16>(                                    \
          fiber_t, xwi, xj, pos, wf8, wfd, wfn, W, B, send_win, win_base,     \
          receivers, chunk_block, row_ptr, row_slots, long_rows, n_layers,    \
          wd, grid, n_tiles, e_pad, edge_block, window, n_rows, n_long,       \
          piece, n_batch, msg, out, stream);                                  \
    });                                                                       \
  }

FUSED_EDGE_PHASE_WIN_DYN(fused_edge_phase_win_dyn_f32, float, false)
FUSED_EDGE_PHASE_WIN_DYN(fused_edge_phase_win_dyn_bf16, __nv_bfloat16, true)
