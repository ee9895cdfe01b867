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
// A batch over the one layout (feat [n_batch][e_pad][W], x and out
// [n_batch][n_rows][W]) is one launch over the batch's n_batch·n_rows rows:
// tile t belongs to sample ⌊t / tiles per sample⌋ (n_rows is a multiple of
// every tile's rows, so no tile straddles two samples), sums its rows'
// lists (rows r − s·n_rows of the layout) from that sample's edge rows,
// s·e_pad·W elements in, and reads x and writes out at its own rows: each
// sample's output is the bits of a call on that sample alone.
//
// Width: the latent width W is 128 or 256 (`with_width`, a template
// parameter CW of every design; ../agg_node.py's `agg_plan` refuses the
// rest before a launch). A warp sums a row's list once per 128-column
// block, each block in kernel 8's order, so the aggregate is still kernel
// 8's bit for bit. The one-block tile gives each thread 4 columns of each
// block (8·R rows × 8 columns at 256: 160 KB of shared memory on 64 rows,
// one block an SM; 64 KB on 16); the cluster is kernel 3's at width W
// (cl_of(W) CTAs a tile: 8 at 256, each summing TR / 8 = 2 of a 16-row
// tile's rows), its size a launch attribute, so one template serves both
// widths. Any number of tail layers: the forward keeps no layer's
// activations.
#include "node_cluster_fwd.cuh"
#include "node_phase.cuh"
#include "row_gather.cuh"

using namespace bsms;
using namespace bsms::node_cluster;

namespace {

// Rows first + w, first + w + NW, ... of the n rows from `first` into
// out[r - first][CW], warp w (of NW) one row at a time, each 128-column
// block of the row in turn, in kernel 8's order: a short list by row_sum
// (list order from zero), a long one as the gather's eight shares (share
// v: its pieces v, v + 8, ..., each a row_sum from zero, added in turn)
// added in share order; rounded to bf16 in BF16 mode. feat has rows of CW.
template <bool BF16, int NW, int CW, typename TF>
__device__ __forceinline__ void sum_rows(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ slots, size_t first, int n, int piece,
    float* out) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += NW) {
    const int i0 = row_ptr[first + r], i1 = row_ptr[first + r + 1];
#pragma unroll
    for (int cb = 0; cb < CW / C; ++cb) {
      const int col = C * cb + 4 * lane;
      float4 s;
      if (i1 - i0 <= piece) {
        s = row_sum(feat, slots, i0, i1, CW, col);
      } else {
        for (int v = 0; v < GATHER_WARPS; ++v) {
          float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int p = i0 + v * piece; p < i1; p += GATHER_WARPS * piece)
            add4(sv, row_sum(feat, slots, p, min(p + piece, i1), CW, col));
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
      *reinterpret_cast<float4*>(out + r * CW + col) = s;
    }
  }
}

// The sample of the batch's row `row` (of n_rows rows a sample; the batch's
// rows fit an int, as the launch checks): its edge rows (e_stride elements
// a sample) and the row's index in the layout.
template <typename TF>
__device__ __forceinline__ const TF* sample_feat(const TF* feat, size_t row,
                                                 int n_rows, size_t e_stride,
                                                 size_t& first) {
  const int s = (int)row / n_rows;
  first = row - (size_t)s * n_rows;
  return feat + s * e_stride;
}

// The one-block tile: 8·R rows, warp w summing rows w, w + 8, ...
template <typename TF, typename TX, typename TO, bool BF16, int R, int CW>
__global__ void __launch_bounds__(THREADS)
fused_aggregate_node_phase_block_kernel(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ row_slots, int piece, const TX* __restrict__ x,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    TO* __restrict__ out, int n_rows, size_t e_stride) {
  extern __shared__ float4 smem4[];
  const size_t row0 = (size_t)blockIdx.x * 8 * R;
  size_t first;
  const TF* feat_s = sample_feat(feat, row0, n_rows, e_stride, first);
  auto fill_aggr = [&](float* tile) {
    sum_rows<BF16, THREADS / 32, CW>(feat_s, row_ptr, row_slots, first,
                                     8 * R, piece, tile);
  };
  node_phase_tile<TX, TO, BF16, R, CW>(x, fill_aggr, W0, b0, W, B, n_layers,
                                       out, row0,
                                       reinterpret_cast<float*>(smem4));
}

// The cluster's aggregate front (node_phase_fwd's `aggr`) on TR-row tiles
// at width CW: CTA q of cl_of(CW) sums rows [q·TR/CL, (q+1)·TR/CL) of its
// tile, warp w rows w, w + 4, ... of those, into its slice (those rows,
// CW wide), from the tile's sample's edge rows.
template <typename TF, int CW>
struct AggrSum {
  const TF* __restrict__ feat;
  const int* __restrict__ row_ptr;
  const int* __restrict__ slots;
  int piece;
  int n_rows;       // rows a sample
  size_t e_stride;  // edge-row elements a sample

  template <bool BF16, int TR>
  __device__ __forceinline__ void start(int q, size_t row0,
                                        float* quarter) const {
    constexpr int RQ = TR / cl_of(CW);  // rows a CTA sums
    size_t first;
    const TF* feat_s = sample_feat(feat, row0, n_rows, e_stride, first);
    sum_rows<BF16, NT3 / 32, CW>(feat_s, row_ptr, slots, first + q * RQ, RQ,
                                 piece, quarter);
    cluster_arrive();  // the slice is written
  }

  template <bool BF16, int TR>
  __device__ __forceinline__ void fill(cg::cluster_group& cluster, size_t,
                                       float* quarter, float* A) const {
    exchange_wait<NT3, TR, true, CW>(cluster, quarter, A);
  }
};

// The cluster on 16-row tiles (RT = 1 row a thread), four CTAs an SM;
// launched in clusters of cl_of(CW) CTAs.
constexpr int CLUSTER_RT = 1;
template <typename TF, typename TX, typename TO, bool BF16, int CW>
__global__ void __launch_bounds__(NT3, 4)
fused_aggregate_node_phase_cluster_kernel(
    const TF* __restrict__ feat, const int* __restrict__ row_ptr,
    const int* __restrict__ row_slots, int piece, const TX* __restrict__ x,
    const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W, const float* __restrict__ B, int n_layers,
    TO* __restrict__ out, int n_rows, size_t e_stride) {
  extern __shared__ float4 smem4[];
  node_phase_fwd<TX, TO, BF16, CLUSTER_RT, CW>(
      x, AggrSum<TF, CW>{feat, row_ptr, row_slots, piece, n_rows, e_stride},
      W0, b0, W, B, n_layers, out, reinterpret_cast<float*>(smem4));
}

// Launches KERNEL on `blocks` blocks of `threads` with `smem` bytes of
// dynamic shared memory (its own for each KERNEL), in clusters of
// `cluster` CTAs where cluster > 1.
template <typename TF, typename TX, typename TO, auto KERNEL>
int launch_on(int blocks, int threads, size_t smem, int cluster,
              const void* feat, const void* row_ptr, const void* row_slots,
              int piece, const void* x, const void* W0, const void* b0,
              const void* W, const void* B, void* out, int n_layers,
              int n_rows, size_t e_stride, void* stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute dims;
  if (cluster > 1) {
    dims.id = cudaLaunchAttributeClusterDimension;
    dims.val.clusterDim.x = cluster;
    dims.val.clusterDim.y = 1;
    dims.val.clusterDim.z = 1;
    cfg.attrs = &dims;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, KERNEL, (const TF*)feat, (const int*)row_ptr,
      (const int*)row_slots, piece, (const TX*)x, (const float*)W0,
      (const float*)b0, (const float*)W, (const float*)B, n_layers, (TO*)out,
      n_rows, e_stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// tile: 0 / 1 the one-block 64- / 16-row tile, 2 the cluster on 16-row
// tiles (agg_node.TILES). n_rows rows and e_pad edge rows a sample, n_batch
// samples, rows of CW.
template <typename TF, typename TX, typename TO, bool BF16, int CW>
int launch(const void* feat, const void* row_ptr, const void* row_slots,
           int piece, const void* x, const void* W0, const void* b0,
           const void* W, const void* B, void* out, int n_layers, int n_rows,
           int tile, int n_batch, int e_pad, void* stream) {
  constexpr int ROWS[3] = {64, 16, RG * CLUSTER_RT};
  if (tile < 0 || tile > 2 || n_layers < 1 || piece < 1 || n_rows < 1 ||
      n_rows % ROWS[tile] || n_batch < 1 || e_pad < 1 ||
      (long long)n_batch * n_rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int tiles = n_batch * (n_rows / ROWS[tile]);
  const size_t e_stride = (size_t)e_pad * CW;
  if (tile == 0)
    return launch_on<TF, TX, TO,
                     fused_aggregate_node_phase_block_kernel<TF, TX, TO,
                                                             BF16, 8, CW>>(
        tiles, THREADS, node_phase_smem<8, CW>(), 1, feat, row_ptr,
        row_slots, piece, x, W0, b0, W, B, out, n_layers, n_rows, e_stride,
        stream);
  if (tile == 1)
    return launch_on<TF, TX, TO,
                     fused_aggregate_node_phase_block_kernel<TF, TX, TO,
                                                             BF16, 2, CW>>(
        tiles, THREADS, node_phase_smem<2, CW>(), 1, feat, row_ptr,
        row_slots, piece, x, W0, b0, W, B, out, n_layers, n_rows, e_stride,
        stream);
  return launch_on<TF, TX, TO,
                   fused_aggregate_node_phase_cluster_kernel<TF, TX, TO,
                                                             BF16, CW>>(
      tiles * cl_of(CW), NT3, fwd_smem_bytes<CLUSTER_RT, CW>(), cl_of(CW),
      feat, row_ptr, row_slots, piece, x, W0, b0, W, B, out, n_layers,
      n_rows, e_stride, stream);
}

}  // namespace

#define FUSED_AGG_NODE(NAME, TF, TX, TO, BF16)                                \
  extern "C" int NAME(const void* feat, const void* row_ptr,                 \
                      const void* row_slots, int piece, const void* x,       \
                      const void* W0, const void* b0, const void* W,         \
                      const void* B, void* out, int n_layers, int n_rows,    \
                      int tile, int n_batch, int e_pad, int width,           \
                      void* stream) {                                        \
    return with_width(width, [&](auto cw) {                                   \
      return launch<TF, TX, TO, BF16, decltype(cw)::value>(                   \
          feat, row_ptr, row_slots, piece, x, W0, b0, W, B, out, n_layers,    \
          n_rows, tile, n_batch, e_pad, stream);                              \
    });                                                                       \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`). In bf16 compute
// the edge features are bf16.
FUSED_AGG_NODE(fused_aggregate_node_phase_f32, float, float, float, false)
FUSED_AGG_NODE(fused_aggregate_node_phase_bf16, __nv_bfloat16, __nv_bfloat16,
               __nv_bfloat16, true)
FUSED_AGG_NODE(fused_aggregate_node_phase_f32_bf16, __nv_bfloat16, float,
               __nv_bfloat16, true)
