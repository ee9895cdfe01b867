// Kernels 12 and 11: the fused GMP edge phase on a streamed first layer
// (see ../fused_gmp_stream.py).
//
//   kernel 12: out[n] = Σ_{e: recv(e)=n} LN(tail(relu(zi[e] + xj[recv_e])))
//   kernel 11: out[n] = Σ_{e: recv(e)=n} LN(tail(relu(pre[e])))
//
// over the slots whose receiver lies in their chunk's 128-row output block.
// The forward tile walk of edge_fwd_tiles.cuh with the streamed front
// (kStream: a persistent grid over the level's 64-slot tiles, dead tiles
// skipped, the tail on the walks' gemm_rows, each live slot's message
// stored into msg), then recv_gather_kernel, the row-ordered
// gather of row_gather.cuh, which sums out from msg over the receiver
// lists (`row_ptr`, `row_slots`, `row_long`: exactly the live slots, in
// slot order, the last block's pad slots on row n_pad − 1). No chunk part
// and no block sum. Each has its own kernel name, so the profiler and the
// launch counters tell them apart from kernel 4. A batch over the one level
// (src [B][E_pad][C], xj [B][n_pad][C]; msg [B][E_pad][C], out
// [B][n_pad][C]) is one launch of each: the walk over B·T tiles, each
// sample's streamed rows e_stride = E_pad·C elements after the last's and
// its xj x_stride = n_pad·C, then the gather with the batch as its grid's y
// extent (msg moving by e_stride, out by x_stride).
#include "edge_fwd_tiles.cuh"
#include "row_gather.cuh"

using namespace bsms;

namespace {

constexpr Front F = Front::kStream;

template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::FWD_MIN_BLOCKS)
fused_edge_phase_kernel(const T* __restrict__ zi, const T* __restrict__ xj,
                        const float* __restrict__ W,
                        const float* __restrict__ B, int n_layers,
                        const int* __restrict__ receivers,
                        const int* __restrict__ chunk_block, int n_tiles,
                        int e_pad, int edge_block, T* __restrict__ msg,
                        int n_batch, size_t x_stride, size_t e_stride) {
  tiles::edge_fwd_tiles<tiles::Base, T, BF16, F>(
      nullptr, zi, xj, nullptr, W, B, n_layers,
                                    nullptr, nullptr, receivers, chunk_block,
                                    n_tiles, e_pad, edge_block, 0, msg,
                                    nullptr, nullptr, nullptr, 0, n_batch,
                                    x_stride, e_stride);
}

// xj is always null here: the signature is kernel 12's, so that one launcher
// takes both.
template <typename T, bool BF16>
__global__ void __launch_bounds__(tiles::NT, tiles::FWD_MIN_BLOCKS)
fused_edge_mlp_aggregate_kernel(const T* __restrict__ pre,
                                const T* __restrict__ xj,
                                const float* __restrict__ W,
                                const float* __restrict__ B, int n_layers,
                                const int* __restrict__ receivers,
                                const int* __restrict__ chunk_block,
                                int n_tiles, int e_pad, int edge_block,
                                T* __restrict__ msg, int n_batch,
                                size_t x_stride, size_t e_stride) {
  tiles::edge_fwd_tiles<tiles::Base, T, BF16, F>(
      nullptr, pre, nullptr, nullptr, W, B,
                                    n_layers, nullptr, nullptr, receivers,
                                    chunk_block, n_tiles, e_pad, edge_block,
                                    0, msg, nullptr, nullptr, nullptr, 0,
                                    n_batch, x_stride, e_stride);
}

template <bool V2, typename T, bool BF16>
auto kernel_of() {
  return V2 ? fused_edge_phase_kernel<T, BF16>
            : fused_edge_mlp_aggregate_kernel<T, BF16>;
}

template <bool V2, typename T, bool BF16>
int blocks_per_sm(int* out) {
  return (int)tiles::fwd_blocks_per_sm<tiles::Base>(kernel_of<V2, T, BF16>(),
                                                    F, out);
}

// V2: kernel 12 (src = zi, with xj), else kernel 11 (src = pre, xj null).
template <bool V2, typename T, bool BF16>
int launch(const void* src, const void* xj, const void* W, const void* B,
           const void* receivers, const void* chunk_block,
           const void* row_ptr, const void* row_slots, const void* long_rows,
           int n_layers, int grid, int n_tiles, int e_pad, int edge_block,
           int n_rows, int n_long, int piece, int n_batch, void* msg,
           void* out, void* stream) {
  if (edge_block % tiles::Base::TR || n_tiles * tiles::Base::TR != e_pad ||
      n_layers < 1 || n_batch < 1 || n_batch > MAX_BATCH ||
      (long long)n_tiles * n_batch > INT_MAX || grid < 1 ||
      grid > n_tiles * n_batch || (xj != nullptr) != V2 || n_rows < 1 ||
      n_long < 0 || piece < 1)
    return (int)cudaErrorInvalidValue;
  const size_t x_stride = (size_t)n_rows * C, e_stride = (size_t)e_pad * C;
  auto kernel = kernel_of<V2, T, BF16>();
  constexpr size_t smem = tiles::fwd_smem_bytes<tiles::Base>(F);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, tiles::NT, smem, s>>>(
      (const T*)src, (const T*)xj, (const float*)W, (const float*)B,
      n_layers, (const int*)receivers, (const int*)chunk_block, n_tiles,
      e_pad, edge_block, (T*)msg, n_batch, x_stride, e_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recv_gather_kernel<T, BF16><<<gather_grid(n_rows, n_long, n_batch),
                                THREADS, 0, s>>>(
      (const T*)msg, (const int*)row_ptr, (const int*)row_slots,
      (const int*)long_rows, n_rows, piece, (float*)out, e_stride, x_stride);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_EDGE_PHASE(NAME, T, BF16)                                       \
  extern "C" int NAME##_blocks_per_sm(int width, int n_layers, int* out) {   \
    (void)n_layers; /* the walk's shared memory is the same at any depth */  \
    return tiles::with_fwd_plan<false>(                                       \
        width, [&](auto) { return blocks_per_sm<true, T, BF16>(out); });      \
  }                                                                           \
  extern "C" int NAME(const void* zi, const void* xj, const void* W,         \
                      const void* B, const void* receivers,                  \
                      const void* chunk_block, const void* row_ptr,          \
                      const void* row_slots, const void* long_rows,          \
                      int width, int n_layers, int grid, int n_tiles,        \
                      int e_pad, int edge_block, int n_rows, int n_long,     \
                      int piece, int n_batch, void* msg, void* out,          \
                      void* stream) {                                        \
    return tiles::with_fwd_plan<false>(width, [&](auto) {                     \
      return launch<true, T, BF16>(zi, xj, W, B, receivers, chunk_block,     \
                                   row_ptr, row_slots, long_rows, n_layers,  \
                                   grid, n_tiles, e_pad, edge_block, n_rows, \
                                   n_long, piece, n_batch, msg, out,         \
                                   stream);                                  \
    });                                                                       \
  }

#define FUSED_EDGE_MLP_AGGREGATE(NAME, T, BF16)                               \
  extern "C" int NAME##_blocks_per_sm(int width, int n_layers, int* out) {   \
    (void)n_layers;                                                           \
    return tiles::with_fwd_plan<false>(                                       \
        width, [&](auto) { return blocks_per_sm<false, T, BF16>(out); });     \
  }                                                                           \
  extern "C" int NAME(const void* pre, const void* W, const void* B,         \
                      const void* receivers, const void* chunk_block,        \
                      const void* row_ptr, const void* row_slots,            \
                      const void* long_rows, int width, int n_layers,        \
                      int grid, int n_tiles, int e_pad, int edge_block,      \
                      int n_rows, int n_long, int piece, int n_batch,        \
                      void* msg, void* out, void* stream) {                  \
    return tiles::with_fwd_plan<false>(width, [&](auto) {                     \
      return launch<false, T, BF16>(pre, nullptr, W, B, receivers,           \
                                    chunk_block, row_ptr, row_slots,         \
                                    long_rows, n_layers, grid, n_tiles,      \
                                    e_pad, edge_block, n_rows, n_long,       \
                                    piece, n_batch, msg, out, stream);       \
    });                                                                       \
  }

FUSED_EDGE_PHASE(fused_edge_phase_f32, float, false)
FUSED_EDGE_PHASE(fused_edge_phase_bf16, __nv_bfloat16, true)
FUSED_EDGE_MLP_AGGREGATE(fused_edge_mlp_aggregate_f32, float, false)
FUSED_EDGE_MLP_AGGREGATE(fused_edge_mlp_aggregate_bf16, __nv_bfloat16, true)
