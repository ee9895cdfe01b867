// The GMP node phase on one row tile, one block per tile, for kernel 10's
// wide levels (agg_node.cu), which sums the aggregate into the tile first:
//
//   out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x
//
// x, the aggregate and every activation stay in shared memory through the
// whole phase. Kernel 3 (node_mlp.cu) and kernel 10's deep levels compute
// the same function with the same arithmetic (one FMA chain per output
// over k in order, the same LayerNorm) on a cluster of CTAs per tile
// (node_cluster_fwd.cuh). CW: the latent width (128 or 256), each thread 4
// columns of each 128-column block of a row.
#pragma once

#include "common.cuh"

namespace bsms {

// Dynamic shared memory of an (8·R)-row tile of width CW: x, the dot
// operands and activations, the staged weight slab.
template <int R, int CW = C>
constexpr size_t node_phase_smem() {
  return sizeof(float) * (2 * 8 * R * CW + KS * CW);
}

// The node phase of rows [row0, row0 + 8·R). `fill_aggr(tile)` writes the
// tile's aggregate rows (f32, CW wide) into `tile`, already rounded to
// bf16 in BF16 mode; it runs between two block barriers. TX: x's type; TO:
// the output's (bf16 in BF16 mode, else TX). BF16 rounds every dot operand
// (x, the aggregate, the hidden activations, the weights) and accumulates
// in f32; LayerNorm and the residual add run in f32.
template <typename TX, typename TO, bool BF16, int R, int CW = C,
          typename FillAggr>
__device__ __forceinline__ void node_phase_tile(
    const TX* __restrict__ x, FillAggr fill_aggr, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W,
    const float* __restrict__ B, int n_layers, TO* __restrict__ out,
    size_t row0, float* smem) {
  constexpr int ROWS = 8 * R;
  float* xs = smem;                // [ROWS][CW] x (f32)
  float* tile = xs + ROWS * CW;    // [ROWS][CW] dot operands, then activations
  float* wslab = tile + ROWS * CW;  // [KS][CW] staged weights
  const int tid = threadIdx.x;
  for (int i = tid; i < ROWS * CW; i += THREADS) {
    xs[i] = to_f(x[row0 * CW + i]);
    if (BF16) tile[i] = round_bf16(xs[i]);  // x as a dot operand
  }
  // pre = x·Wa + aggr·Wb + b0 (one f32 accumulator over both halves); the
  // residual below adds the unrounded x. tile_gemm ends with a barrier, so
  // the aggregate may overwrite the x operand right after.
  float acc[R][4 * (CW / C)] = {};
  tile_gemm<BF16, R, CW>(acc, BF16 ? tile : xs, W0, wslab);
  fill_aggr(tile);
  tile_gemm<BF16, R, CW>(acc, tile, W0 + CW * CW, wslab);
  tile_store<R, CW>(acc, b0, tile, true, BF16);
  tile_mlp_tail<BF16, R, CW>(tile, W, B, n_layers, wslab);
  for (int i = tid; i < ROWS * CW; i += THREADS)
    store(&out[row0 * CW + i], tile[i] + xs[i]);
}

}  // namespace bsms
