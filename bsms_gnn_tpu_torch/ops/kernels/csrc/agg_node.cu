// Kernel 10: the fused aggregation + GMP node phase (see ../agg_node.py),
// replacing the TPU kernel `bsms_gnn_tpu/ops/pallas/agg_node.py:74`:
//
//   out = LN(tail(relu(x·Wa + (Σ_recv feat)·Wb + b0))) + x
//
// The aggregate never reaches device memory: each tile sums its rows' slot
// lists on chip, a warp one row at a time (`sum_rows`), in kernel 8's
// order (segment_sum.cu on row_gather.cuh): a list of up to `piece` slots
// in list order (row_sum.cuh); a longer one as the eight shares of the
// gather's long-list block (share v: pieces v, v + 8, ..., each summed
// from zero and added in turn) added in share order. So the aggregate
// equals kernel 8's bit for bit, and rounded to bf16 in BF16 mode (the
// dot operand) it feeds one of two node phases with kernel 3's arithmetic
// (one FMA chain per output over k in order, x's half first), picked per
// level by ../agg_node.py's `tile_design`:
// - the one-block tile (node_phase.cuh): a block of 256 threads per tile
//   of 8·R rows (R = 8: 64 rows; R = 2: 16 rows), warp w summing rows w,
//   w + 8, ... into shared memory after the x·Wa half of the first
//   product, the whole phase in the block: the most work an SM per unit
//   of time, for the wide levels, where the tiles fill the card;
// - kernel 3's cluster (node_cluster_fwd.cuh) on 16-row tiles: CTA q of 4
//   sums rows [4q, 4q + 4) of its tile (a row a warp) into its second
//   exchange slice, arrives at the cluster barrier and runs the x·Wa half
//   while its peers finish; each CTA then copies the four quarters through
//   distributed shared memory into its A (exchange_wait, by rows). Each
//   tile's chain of products is four times shorter and its lists are
//   walked by four times the warps: the deep levels, few rows with long
//   lists (on the 16k surface, levels 4-7: 1,024 to 128 rows, up to 183
//   slots), where one block per tile leaves most SMs idle.
#include "node_cluster_fwd.cuh"
#include "node_phase.cuh"
#include "row_gather.cuh"

using namespace bsms;
using namespace bsms::node_cluster;

namespace {

// Rows first + w, first + w + NW, ... of the n rows from `first` into
// out[r - first][C], warp w (of NW) one row at a time in kernel 8's order:
// a short list by row_sum (list order from zero), a long one as the
// gather's eight shares (share v: its pieces v, v + 8, ..., each a row_sum
// from zero, added in turn) added in share order; rounded to bf16 in BF16
// mode.
template <bool BF16, int NW, typename TF>
__device__ __forceinline__ void sum_rows(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ slots, size_t first, int n, int piece,
    float* out) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += NW) {
    const int i0 = row_ptr[first + r], i1 = row_ptr[first + r + 1];
    float4 s;
    if (i1 - i0 <= piece) {
      s = row_sum(feat, slots, i0, i1, C, 4 * lane);
    } else {
      for (int v = 0; v < GATHER_WARPS; ++v) {
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p = i0 + v * piece; p < i1; p += GATHER_WARPS * piece)
          add4(sv, row_sum(feat, slots, p, min(p + piece, i1), C, 4 * lane));
        if (v == 0)
          s = sv;
        else
          add4(s, sv);
      }
    }
    if (BF16) {
      s.x = round_bf16(s.x); s.y = round_bf16(s.y);
      s.z = round_bf16(s.z); s.w = round_bf16(s.w);
    }
    *reinterpret_cast<float4*>(out + r * C + 4 * lane) = s;
  }
}

// The one-block tile: 8·R rows, warp w summing rows w, w + 8, ...
template <typename TF, typename TX, typename TO, bool BF16, int R>
__global__ void __launch_bounds__(THREADS)
fused_aggregate_node_phase_block_kernel(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ row_slots, int piece, const TX* __restrict__ x,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const size_t row0 = (size_t)blockIdx.x * 8 * R;
  auto fill_aggr = [&](float* tile) {
    sum_rows<BF16, THREADS / 32>(feat, row_ptr, row_slots, row0, 8 * R, piece,
                                 tile);
  };
  node_phase_tile<TX, TO, BF16, R>(x, fill_aggr, W0, b0, W, B, n_layers, out,
                                   row0, reinterpret_cast<float*>(smem4));
}

// The cluster's aggregate front (node_phase_fwd's `aggr`) on TR-row tiles:
// CTA q sums rows [q·TR/CL, (q+1)·TR/CL) of its tile, warp w rows w, w +
// 4, ... of those, into its quarter.
template <typename TF>
struct AggrSum {
  const TF* __restrict__ feat;
  const int* __restrict__ row_ptr;
  const int* __restrict__ slots;
  int piece;

  template <bool BF16, int TR>
  __device__ __forceinline__ void start(int q, size_t row0,
                                        float* quarter) const {
    sum_rows<BF16, NT3 / 32>(feat, row_ptr, slots, row0 + q * (TR / CL),
                             TR / CL, piece, quarter);
    cluster_arrive();  // the quarter is written
  }

  template <bool BF16, int TR>
  __device__ __forceinline__ void fill(cg::cluster_group& cluster, size_t,
                                       float* quarter, float* A) const {
    exchange_wait<NT3, TR, true>(cluster, quarter, A);
  }
};

// The cluster on 16-row tiles (RT = 1 row a thread), four CTAs an SM.
constexpr int CLUSTER_RT = 1;
template <typename TF, typename TX, typename TO, bool BF16>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT3, 4)
fused_aggregate_node_phase_cluster_kernel(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ row_slots, int piece, const TX* __restrict__ x,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  node_phase_fwd<TX, TO, BF16, CLUSTER_RT>(
      x, AggrSum<TF>{feat, row_ptr, row_slots, piece}, W0, b0, W, B,
      n_layers, out, reinterpret_cast<float*>(smem4));
}

// Launches KERNEL on `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory (its own for each KERNEL).
template <typename TF, typename TX, typename TO, auto KERNEL>
int launch_on(int blocks, int threads, size_t smem, const void* feat,
              const void* row_ptr, const void* row_slots, int piece,
              const void* x, const void* W0, const void* b0, const void* W,
              const void* B, void* out, int n_layers, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  KERNEL<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const TF*)feat, (const int*)row_ptr, (const int*)row_slots, piece,
      (const TX*)x, (const float*)W0, (const float*)b0, (const float*)W,
      (const float*)B, n_layers, (TO*)out);
  return (int)cudaGetLastError();
}

// tile: 0 / 1 the one-block 64- / 16-row tile, 2 the cluster on 16-row
// tiles (agg_node.TILES).
template <typename TF, typename TX, typename TO, bool BF16>
int launch(const void* feat, const void* row_ptr, const void* row_slots,
           int piece, const void* x, const void* W0, const void* b0,
           const void* W, const void* B, void* out, int n_layers, int n_rows,
           int tile, void* stream) {
  constexpr int ROWS[3] = {64, 16, RG * CLUSTER_RT};
  if (tile < 0 || tile > 2 || n_layers < 1 || piece < 1 || n_rows < 1 ||
      n_rows % ROWS[tile])
    return (int)cudaErrorInvalidValue;
  const int tiles = n_rows / ROWS[tile];
  if (tile == 0)
    return launch_on<TF, TX, TO,
                     fused_aggregate_node_phase_block_kernel<TF, TX, TO,
                                                             BF16, 8>>(
        tiles, THREADS, node_phase_smem<8>(), feat, row_ptr, row_slots, piece,
        x, W0, b0, W, B, out, n_layers, stream);
  if (tile == 1)
    return launch_on<TF, TX, TO,
                     fused_aggregate_node_phase_block_kernel<TF, TX, TO,
                                                             BF16, 2>>(
        tiles, THREADS, node_phase_smem<2>(), feat, row_ptr, row_slots, piece,
        x, W0, b0, W, B, out, n_layers, stream);
  return launch_on<TF, TX, TO,
                   fused_aggregate_node_phase_cluster_kernel<TF, TX, TO,
                                                             BF16>>(
      tiles * CL, NT3, fwd_smem_bytes<CLUSTER_RT>(), feat, row_ptr, row_slots,
      piece, x, W0, b0, W, B, out, n_layers, stream);
}

}  // namespace

#define FUSED_AGG_NODE(NAME, TF, TX, TO, BF16)                                \
  extern "C" int NAME(const void* feat, const void* row_ptr,                 \
                      const void* row_slots, int piece, const void* x,       \
                      const void* W0, const void* b0, const void* W,         \
                      const void* B, void* out, int n_layers, int n_rows,    \
                      int tile, void* stream) {                              \
    return launch<TF, TX, TO, BF16>(feat, row_ptr, row_slots, piece, x, W0,  \
                                    b0, W, B, out, n_layers, n_rows, tile,   \
                                    stream);                                 \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`). In bf16 compute
// the edge features are bf16.
FUSED_AGG_NODE(fused_aggregate_node_phase_f32, float, float, float, false)
FUSED_AGG_NODE(fused_aggregate_node_phase_bf16, __nv_bfloat16, __nv_bfloat16,
               __nv_bfloat16, true)
FUSED_AGG_NODE(fused_aggregate_node_phase_f32_bf16, __nv_bfloat16, float,
               __nv_bfloat16, true)
