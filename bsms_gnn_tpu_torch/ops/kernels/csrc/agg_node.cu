// Kernel 10: the fused aggregation + GMP node phase (see ../agg_node.py).
//
//   out = LN(tail(relu(x·Wa + (Σ_recv feat)·Wb + b0))) + x
//
// One block per row tile of 8·R rows: the tile's aggregate is summed into
// shared memory, one warp per row in slot order (`row_sum.cuh`, as kernel
// 8 sums it), and the one-block node phase of `node_phase.cuh` (kernel 3's
// function and order of sums) runs on it in place; the aggregate never reaches device memory. R = 8 (64-row
// tiles) where that gives the card at least one block per SM, else R = 2
// (16-row tiles) so that the deep levels, few rows with ~100 slots each,
// spread their sums over four times as many SMs.
#include "node_phase.cuh"
#include "row_sum.cuh"

using namespace bsms;

namespace {

// TF: feat's type; TX: x's; TO: the output's (bf16 in BF16 mode, else TX).
template <typename TF, typename TX, typename TO, bool BF16, int R>
__global__ void __launch_bounds__(THREADS)
fused_aggregate_node_phase_kernel(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ row_slots, const TX* __restrict__ x,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  constexpr int ROWS = 8 * R;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  auto fill_aggr = [&](float* tile) {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < ROWS; r += THREADS / 32) {
      const size_t row = row0 + r;
      float4 s = row_sum(feat, row_slots, row_ptr[row], row_ptr[row + 1], C,
                         4 * lane);
      if (BF16) {
        s.x = round_bf16(s.x); s.y = round_bf16(s.y);
        s.z = round_bf16(s.z); s.w = round_bf16(s.w);
      }
      *reinterpret_cast<float4*>(tile + r * C + 4 * lane) = s;
    }
  };
  node_phase_tile<TX, TO, BF16, R>(x, fill_aggr, W0, b0, W, B, n_layers, out,
                                   row0, reinterpret_cast<float*>(smem4));
}

template <typename TF, typename TX, typename TO, bool BF16, int R>
int launch(const void* feat, const void* row_ptr, const void* row_slots,
           const void* x, const void* W0, const void* b0, const void* W,
           const void* B, void* out, int n_layers, int n_rows, void* stream) {
  auto kernel = fused_aggregate_node_phase_kernel<TF, TX, TO, BF16, R>;
  constexpr size_t smem = node_phase_smem<R>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_rows / (8 * R), THREADS, smem, (cudaStream_t)stream>>>(
      (const TF*)feat, (const int*)row_ptr, (const int*)row_slots,
      (const TX*)x, (const float*)W0, (const float*)b0, (const float*)W,
      (const float*)B, n_layers, (TO*)out);
  return (int)cudaGetLastError();
}

template <typename TF, typename TX, typename TO, bool BF16>
int launch_rows(const void* feat, const void* row_ptr, const void* row_slots,
                const void* x, const void* W0, const void* b0, const void* W,
                const void* B, void* out, int n_layers, int n_rows,
                int tile_rows, void* stream) {
  if (tile_rows == 64 && n_rows % 64 == 0)
    return launch<TF, TX, TO, BF16, 8>(feat, row_ptr, row_slots, x, W0, b0, W,
                                       B, out, n_layers, n_rows, stream);
  if (tile_rows == 16 && n_rows % 16 == 0)
    return launch<TF, TX, TO, BF16, 2>(feat, row_ptr, row_slots, x, W0, b0, W,
                                       B, out, n_layers, n_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define FUSED_AGG_NODE(NAME, TF, TX, TO, BF16)                                \
  extern "C" int NAME(const void* feat, const void* row_ptr,                 \
                      const void* row_slots, const void* x, const void* W0,  \
                      const void* b0, const void* W, const void* B,          \
                      void* out, int n_layers, int n_rows, int tile_rows,    \
                      void* stream) {                                        \
    return launch_rows<TF, TX, TO, BF16>(feat, row_ptr, row_slots, x, W0,    \
                                         b0, W, B, out, n_layers, n_rows,    \
                                         tile_rows, stream);                 \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`). In bf16 compute
// the edge features are bf16.
FUSED_AGG_NODE(fused_aggregate_node_phase_f32, float, float, float, false)
FUSED_AGG_NODE(fused_aggregate_node_phase_bf16, __nv_bfloat16, __nv_bfloat16,
               __nv_bfloat16, true)
FUSED_AGG_NODE(fused_aggregate_node_phase_f32_bf16, __nv_bfloat16, float,
               __nv_bfloat16, true)
