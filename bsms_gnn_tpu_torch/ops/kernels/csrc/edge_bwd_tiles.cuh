// The backward edge walk of kernels 5 (fused_gmp_bwd.cu), 13's backward
// (fused_gmp_dyn_bwd.cu) and 11's and 12's backwards
// (fused_gmp_stream_bwd.cu), replacing the TPU kernels
// `bsms_gnn_tpu/ops/pallas/fused_gmp.py:607` (`_get_bwd3`, front kWin),
// `:706` (`_get_bwd4`, front kDyn: kWin plus the world-space terms), `:260`
// (`_get_bwd`, front kStream, the streamed pre-activation) and `:407`
// (`_get_bwd2`, front kStream with the receiver row xj[recv_e] added on the
// slots whose receiver lies in their chunk's block).
// Per slot e it computes, with the TPU kernels' rounding points: the
// forward recomputed, the LayerNorm backward of the edge cotangent
// g[recv_e] (zero where the slot is masked), the tail layers in reverse,
// and
//   dpre[e]        the first-layer pre-activation's cotangent (stored),
//   dW[l], db[l]   the tail's weight gradients,
//   dwf8           = fiber_t · dpre (kWin, kDyn),
//   dwf_dyn        = Δᵀ · dpre (kDyn; bf16 operands in BF16 mode),
//   dwf_nrm        = Σ_e ‖Δ_e‖ · dpre[e] (kDyn; f32, dpre before its bf16
//                    rounding),
// with Δ_e = pos[send_e] − pos[recv_e] taken in f32 from the positions as
// stored, as kernel 13's forward takes it (edge_fwd_tiles.cuh, the same
// front). The positions get no cotangent. dxj is not summed here: the caller gathers it from dpre over
// the receiver lists (row_gather.cuh), so no shared dxj block is kept.
//
// What bounds it: operations, in true f32 on the CUDA cores (no TF32): per
// live slot about 6·L·128² FLOP of products, against a few hundred bytes.
//
// What the design does about it:
// - A persistent grid over tiles, not chunks: G blocks (the SM count times
//   the blocks per SM the kernel reaches, at most the tiles), block b
//   walking the contiguous tile range [⌊b·T/G⌋, ⌊(b+1)·T/G⌋) of the
//   level's T = E_pad / TR tiles in order; each tile finds its chunk (and
//   so its output block and window) from its first slot, so that a level
//   of few chunks still spreads its tiles over every SM.
// - A dead tile (no slot with s_loc >= 0) writes zero dpre rows and skips
//   the recompute and the GEMMs; a block that meets no live tile writes a
//   zero partial. dpre stays exactly zero on every masked slot.
// - One weight-gradient partial per block ([dW | db | dwf8] for kWin, the
//   same plus [dwf_dyn | dwf_nrm] for kDyn, [dW | db] for kStream), read
//   and written only by that block across its tiles (the old values load
//   before each product, hidden behind it), then summed over the G blocks
//   in block order by grad_sum_kernel (backward.cuh): G × ~200 KB that
//   stay in L2, no atomics, the same result from run to run (G depends
//   only on the card and the kernel).
// - A batch of B samples over the one level (kernels 5, 13's and 14's
//   backwards: xwi, xj, g [B][n_pad][C], dpre [B][E_pad][C], kernel 13's
//   positions [B][n_pad][wd]) walks B·T tiles, tile t being tile
//   t mod T of sample ⌊t / T⌋, in the same ranges [⌊b·BT/G⌋,
//   ⌊(b+1)·BT/G⌋): still G partials, each block summing every sample's
//   tiles of its range into its own, and a sample's dpre the bits of a call
//   on that sample alone. Kernels 11's and 12's backwards (kStream) take
//   it the same way, each sample's streamed rows src [E_pad][C] e_stride
//   elements after the last's.
// - The tail weights' 64-row slabs are double-buffered with cp.async: the
//   next slab loads while the current one is used, one barrier per slab,
//   and each GEMM's last slab step issues the next GEMM's first slab. In
//   BF16 mode W and Wᵀ come already rounded to bf16 values (stored as f32),
//   so the copy rounds nothing.
// - The weight-gradient product gives each thread an 8×8 block whose
//   columns make half-warps read contiguous rows (no bank conflict); the
//   rows' loads of the first-layer front and of g go out together.
// - No 64 KB dxj block and no per-chunk part.
// The tile shape was chosen by a sweep on an H100 (PERF.md): 64-row tiles
// of 256 threads at one block per SM beat 32-row tiles at two blocks per
// SM at the 5k airfoil's level 0 and tied at the 16k surface's (two blocks
// per SM did not overlap: the products' shared-memory reads and FMAs
// already bound a tile with one block alone); 64-row slabs (two barriers
// per GEMM) with the products' loops unrolled further (255 registers
// allowed at one block per SM, 221 used, no spill) took another 8%.
// - Width and depth (`Plan`): the walks are templates on a plan (the
//   latent width C, TR slots a tile, KS weight rows a slab), picked at
//   launch by the width and the tail layers as the first of the width's
//   plans whose shared memory fits a block (`with_bwd_plan`; the wrappers'
//   `fused_gmp.walk_plan` is its mirror): C = 128 takes `Base` (64, 64),
//   the plan above, while its L + 1 tiles fit (L ≤ 3; kStream L ≤ 4), then
//   `Deep` (32-slot tiles: L ≤ 8); C = 256 takes `Wide` (32-slot tiles,
//   16-row slabs: L ≤ 4). A row of C = 256 is two 128-column halves, each
//   lane 4 columns of each (V = 2 float4s), every output still one fmaf
//   chain in k order from zero; a message, dpre and dW element do not
//   depend on the plan but through the order in which a block's tiles add
//   into its partial. Every kernel instantiates the plans of the widths it
//   takes (kernels 11-14: C = 128).
#pragma once

#include "backward.cuh"
#include "edge_tile.cuh"
#include "row_sum.cuh"  // load4

namespace bsms {
namespace tiles {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int MIN_BLOCKS = 1;
// The shared memory one block may hold on an H100 (227 KB).
constexpr size_t SMEM_MAX = 232448;

// A tile plan: latent width C_ (V = C_ / C float4s a lane, lane l holding
// columns 4l + C·v), TR_ slots a tile (RW rows a warp, HB of them with
// their loads in flight together), KS_ weight rows a staged slab.
template <int C_, int TR_, int KS_>
struct Plan {
  static constexpr int C = C_;
  static constexpr int TR = TR_;
  static constexpr int KS = KS_;
  static constexpr int V = C_ / bsms::C;
  static constexpr int RW = TR_ / NW;
  static constexpr int HB = RW < 4 ? RW : 4;
  static_assert(C_ % bsms::C == 0 && NT % TR_ == 0 && TR_ % NW == 0 &&
                    RW >= 1 && RW % HB == 0 && (C_ / KS_) % 2 == 0 &&
                    (C_ <= NT || C_ % NT == 0),
                "tile plan");
};
using Base = Plan<128, 64, 64>;     // C = 128 (fused_gmp.TILE_ROWS slots)
using Deep = Plan<128, 32, 64>;     // C = 128, tail layers past Base's
using Wide = Plan<256, 32, 16>;     // C = 256, the backward
using WideFwd = Plan<256, 32, 32>;  // C = 256, the forward
static_assert(Base::TR == 64, "the wrappers size Base's tiles by "
                              "fused_gmp.TILE_ROWS");

// Shared memory of the walk at n_layers tail layers (floats, then the
// three int tables of the tile's slots): kDyn adds wf_dyn, wf_nrm and the
// tile's Δ and ‖Δ‖.
template <class P>
constexpr size_t smem_bytes(int n_layers, Front f) {
  return sizeof(float) * ((size_t)(n_layers + 1) * P::TR * P::C +
                          2 * P::KS * P::C +
                          (f != Front::kStream ? 8 * P::C + 8 * P::TR : 0) +
                          (f == Front::kDyn ? MAX_WD * P::C + P::C +
                                                  MAX_WD * P::TR + P::TR
                                            : 0)) +
         sizeof(int) * 3 * P::TR;
}

// The most tail layers plan P's walk holds with front f.
template <class P>
constexpr int max_layers(Front f) {
  int l = 0;
  while (smem_bytes<P>(l + 1, f) <= SMEM_MAX) ++l;
  return l;
}

// Calls fn(P{}) with the backward walk's plan for a latent width and
// n_layers tail layers (the first of the width's plans whose shared memory
// fits), or returns cudaErrorInvalidValue where none does. WIDE: whether
// the caller instantiates C = 256.
template <bool WIDE, typename Fn>
int with_bwd_plan(int width, int n_layers, Front f, Fn&& fn) {
  if (n_layers < 1) return (int)cudaErrorInvalidValue;
  if (width == Base::C) {
    if (smem_bytes<Base>(n_layers, f) <= SMEM_MAX) return fn(Base{});
    if (smem_bytes<Deep>(n_layers, f) <= SMEM_MAX) return fn(Deep{});
  }
  if constexpr (WIDE)
    if (width == Wide::C && smem_bytes<Wide>(n_layers, f) <= SMEM_MAX)
      return fn(Wide{});
  return (int)cudaErrorInvalidValue;
}

// Floats of one block's weight-gradient partial (wd: kDyn's world-stream
// width).
template <class P>
__host__ __device__ inline int grad_size(int n_layers, Front f, int wd = 0) {
  constexpr int C = P::C;
  return n_layers * C * C + n_layers * C +
         (f != Front::kStream ? 8 * C : 0) +
         (f == Front::kDyn ? wd * C + C : 0);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issues the copy of W's slab s (KS rows) into buffer s mod 2 of `wslab`
// (cp.async, one commit group).
template <class P>
__device__ __forceinline__ void copy_slab(const float* __restrict__ W, int s,
                                          float* wslab) {
  constexpr int C = P::C, KS = P::KS;
  const float* src = W + (size_t)s * KS * C;
  float* dst = wslab + (s & 1) * KS * C;
  for (int i = threadIdx.x; i < KS * C / 4; i += NT)
    cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

// acc[i][4v + j] += Σ_k in[(RW·ty + i)·C + k] · W[k·C + 128v + 4·tx + j]
// over k < C: the TR×C tile `in` (shared) times the C×C weight W (device,
// [in, out], bf16 values already in BF16 mode), W staged in KS-row slabs
// through the two buffers of `wslab` by cp.async, slab s + 1 in flight
// while slab s is used. W's first slab must be in flight already
// (copy_slab(W, 0)); during the last slab this issues the first slab of
// `next`, the walk's next GEMM, so no GEMM waits for its first load. Each
// warp reads and the caller writes only the warp's own RW rows. The
// barrier of the first slab also orders the caller's writes of `in`; there
// is none at the end.
template <class P>
__device__ __forceinline__ void gemm_rows(float (&acc)[P::RW][4 * P::V],
                                          const float* in,
                                          const float* __restrict__ W,
                                          const float* __restrict__ next,
                                          float* wslab) {
  constexpr int C = P::C, KS = P::KS, RW = P::RW, V = P::V;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  constexpr int STEPS = C / KS;
  static_assert(STEPS % 2 == 0, "the next GEMM's first slab takes buffer 0");
  for (int s = 0; s < STEPS; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < STEPS) copy_slab<P>(W, s + 1, wslab);
    else copy_slab<P>(next, 0, wslab);
    const float* ws = wslab + (s & 1) * KS * C;
    const int k0 = s * KS;
#pragma unroll 8
    for (int k = 0; k < KS; k += 4) {
      float4 a[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        a[i] = *reinterpret_cast<const float4*>(in + (RW * ty + i) * C + k0 + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 w[V];
#pragma unroll
        for (int v = 0; v < V; ++v)
          w[v] = reinterpret_cast<const float4*>(ws + (k + kk) * C)[tx + 32 * v];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[i][4 * v + 0] = fmaf(av, w[v].x, acc[i][4 * v + 0]);
            acc[i][4 * v + 1] = fmaf(av, w[v].y, acc[i][4 * v + 1]);
            acc[i][4 * v + 2] = fmaf(av, w[v].z, acc[i][4 * v + 2]);
            acc[i][4 * v + 3] = fmaf(av, w[v].w, acc[i][4 * v + 3]);
          }
        }
      }
    }
  }
}

// out rows = acc + bias in gemm_rows' layout, optionally ReLU'd and
// rounded to bf16.
template <class P>
__device__ __forceinline__ void store_rows(const float (&acc)[P::RW][4 * P::V],
                                           const float* __restrict__ bias,
                                           float* out, bool relu, bool to_bf16) {
  constexpr int C = P::C, RW = P::RW, V = P::V;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 b = reinterpret_cast<const float4*>(bias)[tx + 32 * v];
    const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = acc[i][4 * v + j] + bb[j];
        if (relu) o[j] = fmaxf(o[j], 0.f);
        if (to_bf16) o[j] = round_bf16(o[j]);
      }
      *reinterpret_cast<float4*>(out + (RW * ty + i) * C + 4 * tx + 128 * v) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

// out = acc ⊙ (mask > 0) in gemm_rows' layout (the ReLU's backward; mask
// is the layer's input). `out` may alias the GEMM's input.
template <class P>
__device__ __forceinline__ void store_rows_masked(
    const float (&acc)[P::RW][4 * P::V], const float* mask, float* out) {
  constexpr int C = P::C, RW = P::RW, V = P::V;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int o = (RW * ty + i) * C + 4 * tx + 128 * v;
      const float4 m = *reinterpret_cast<const float4*>(mask + o);
      *reinterpret_cast<float4*>(out + o) = make_float4(
          m.x > 0.f ? acc[i][4 * v + 0] : 0.f,
          m.y > 0.f ? acc[i][4 * v + 1] : 0.f,
          m.z > 0.f ? acc[i][4 * v + 2] : 0.f,
          m.w > 0.f ? acc[i][4 * v + 3] : 0.f);
    }
}

// dst (+)= AᵀB over the TR rows of two TR×C shared tiles: the [C, C]
// product in 8×8 register blocks, block q < (C/8)² taken by thread q mod
// NT: rows i0..i0+3 and H+i0..H+i0+3, columns j0..j0+3 and H+j0..H+j0+3
// (H = C/2), with i0 = 4·(q / (C/8)), j0 = 4·(q % (C/8)), so that the
// column groups of a half-warp read 256 contiguous bytes of a B row (no
// bank conflict) and its rows of A are one broadcast. Each thread touches
// only its own elements of dst: a sum over the tile's rows in row order,
// added to (or, when !add, stored as) the block's partial.
template <class P>
__device__ __forceinline__ void gemm_tn_store(const float* A, const float* B,
                                              float* dst, bool add) {
  constexpr int C = P::C, TR = P::TR, H = C / 2, G = C / 8;
  for (int q = threadIdx.x; q < G * G; q += NT) {
    const int i0 = (q / G) * 4, j0 = (q % G) * 4;
    // The partial's old values load before the product, so that their
    // latency hides behind it.
    float4 old[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* row = dst + (size_t)((i < 4 ? 0 : H) + i0 + (i & 3)) * C;
      old[i][0] = add ? *reinterpret_cast<const float4*>(row + j0)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      old[i][1] = add ? *reinterpret_cast<const float4*>(row + H + j0)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float acc[8][8] = {};
#pragma unroll 4
    for (int r = 0; r < TR; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + r * C + i0);
      const float4 a1 = *reinterpret_cast<const float4*>(A + r * C + H + i0);
      const float4 b0 = *reinterpret_cast<const float4*>(B + r * C + j0);
      const float4 b1 = *reinterpret_cast<const float4*>(B + r * C + H + j0);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = dst + (size_t)((i < 4 ? 0 : H) + i0 + (i & 3)) * C;
      float4* p0 = reinterpret_cast<float4*>(row + j0);
      float4* p1 = reinterpret_cast<float4*>(row + H + j0);
      float4 v0 = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      float4 v1 = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      if (add) {
        const float4 o0 = old[i][0], o1 = old[i][1];
        v0.x += o0.x; v0.y += o0.y; v0.z += o0.z; v0.w += o0.w;
        v1.x += o1.x; v1.y += o1.y; v1.z += o1.z; v1.w += o1.w;
      }
      *p0 = v0;
      *p1 = v1;
    }
  }
}

// Rounds the TR×C tile to bf16 in place, between two block barriers.
template <class P>
__device__ __forceinline__ void round_tile(float* t) {
  __syncthreads();
  for (int i = threadIdx.x; i < P::TR * P::C; i += NT) t[i] = round_bf16(t[i]);
  __syncthreads();
}

// Fills the slot tables of the TR slots from t0 (in chunk ch) and, with
// kWin and kDyn, the tile's fiber stream (rounded in BF16 mode); with kDyn
// also dyn.delta [MAX_WD][TR] (Δ, rounded in BF16 mode as the dot operand;
// zero sender position for an out-of-window slot) and dyn.nrm [TR] (‖Δ‖ in
// f32 from the unrounded Δ); kStream sets
// s_row to the receiver row where it lies in the chunk's block and -1
// elsewhere (the rows kernel 12's front reads from xj). Returns whether any
// slot is live (kWin, kDyn: an in-window sender and a receiver in the
// chunk's block; kStream: the receiver alone), the same in every thread.
// Starts with a block barrier (the previous tile is done with the tables)
// and ends with one.
template <class P, bool BF16, Front F, typename T = float>
__device__ __forceinline__ bool tile_slots(
    int t0, int ch, const float* __restrict__ fiber_t,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int e_pad, int window, int* s_row, int* s_recv, int* s_loc, float* fib,
    const DynFiber<T>& dyn = {}) {
  constexpr int TR = P::TR;
  constexpr bool WIN = F != Front::kStream;
  const int tid = threadIdx.x;
  const int row0 = chunk_block[ch] * BN;
  __syncthreads();
  bool live = false;
  if (tid < TR) {
    const int e = t0 + tid, r = receivers[e], loc = r - row0;
    bool keep = loc >= 0 && loc < BN;
    if constexpr (WIN) {
      const int sw = send_win[e];
      const bool in_win = sw < window;
      const int row = win_base[ch] * (window / 2) + sw;
      s_row[tid] = in_win ? row : -1;
      keep = keep && in_win;
      if constexpr (F == Front::kDyn) {
        float d2 = 0.f;
        for (int k = 0; k < dyn.wd; ++k) {
          const float ps =
              in_win ? to_f(dyn.pos[(size_t)row * dyn.wd + k]) : 0.f;
          const float dv = ps - to_f(dyn.pos[(size_t)r * dyn.wd + k]);
          d2 = fmaf(dv, dv, d2);
          dyn.delta[k * TR + tid] = BF16 ? round_bf16(dv) : dv;
        }
        dyn.nrm[tid] = sqrtf(d2);
      }
    } else {
      s_row[tid] = keep ? r : -1;
    }
    s_recv[tid] = r;
    s_loc[tid] = keep ? loc : -1;
    live = keep;
  }
  if constexpr (WIN)
    for (int i = tid; i < 8 * TR; i += NT) {
      const float f = fiber_t[(size_t)(i / TR) * e_pad + t0 + i % TR];
      fib[i] = BF16 ? round_bf16(f) : f;
    }
  return __syncthreads_or(live);
}

// relu(pre) of the tile's rows into `h` (rounded in BF16 mode, as the next
// dot operand). kWin: pre = fiber·wf8 + xwi[send] + xj[recv], with `wf` the
// [8][C] fiber weights and `fib` the tile's fiber stream in shared memory;
// kDyn: that plus Δ·wf_dyn + ‖Δ‖·wf_nrm from `dyn` (tile_slots' Δ and ‖Δ‖,
// the weights in shared memory), added after the kWin sum; kStream:
// pre = src[t0 + r], plus xj[s_row[r]] where xj is given (kernel 12) and
// the slot's receiver lies in its chunk's block. A warp owns rows warp +
// j·NW, each lane 4 columns of each 128-column half; each group of HB
// rows' loads is issued before their arithmetic.
template <class P, typename T, bool BF16, Front F>
__device__ __forceinline__ void tile_front(int t0, const T* __restrict__ src,
                                           const T* __restrict__ xj,
                                           const float* wf, const float* fib,
                                           const int* s_row, const int* s_recv,
                                           float* h,
                                           const DynFiber<T>& dyn = {}) {
  constexpr int C = P::C, TR = P::TR, RW = P::RW, HB = P::HB, V = P::V;
  constexpr bool WIN = F != Front::kStream;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < RW; j0 += HB) {
    float4 a[HB][V], z[HB][V];
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int r = warp + (j0 + j) * NW;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c4 = 4 * lane + 128 * v;
        if constexpr (WIN) {
          const int row = s_row[r];
          a[j][v] = row >= 0 ? load4(src + (size_t)row * C + c4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
          z[j][v] = load4(xj + (size_t)s_recv[r] * C + c4);
        } else {
          a[j][v] = load4(src + (size_t)(t0 + r) * C + c4);
          z[j][v] = xj != nullptr && s_row[r] >= 0
                        ? load4(xj + (size_t)s_row[r] * C + c4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HB; ++j) {
      const int r = warp + (j0 + j) * NW;
#pragma unroll
      for (int vv = 0; vv < V; ++vv) {
        const int c4 = 4 * lane + 128 * vv;
        float v[4] = {a[j][vv].x, a[j][vv].y, a[j][vv].z, a[j][vv].w};
        if constexpr (WIN) {
          const float zz[4] = {z[j][vv].x, z[j][vv].y, z[j][vv].z, z[j][vv].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float f = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              f = fmaf(fib[k * TR + r], wf[k * C + c4 + q], f);
            v[q] = (f + v[q]) + zz[q];
            if constexpr (F == Front::kDyn) {
              float fd = 0.f;
              for (int k = 0; k < dyn.wd; ++k)
                fd = fmaf(dyn.delta[k * TR + r], dyn.wfd[k * C + c4 + q], fd);
              v[q] = (v[q] + fd) + dyn.nrm[r] * dyn.wfn[c4 + q];
            }
          }
        } else if (xj != nullptr) {
          v[0] += z[j][vv].x; v[1] += z[j][vv].y;
          v[2] += z[j][vv].z; v[3] += z[j][vv].w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = fmaxf(v[q], 0.f);
          if (BF16) v[q] = round_bf16(v[q]);
        }
        *reinterpret_cast<float4*>(h + r * C + c4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// The walk. kWin: xwi, xj, fiber_t, wf8, send_win and win_base as kernel
// 4's; kDyn (kernel 13): those plus the positions pos [n_pad][wd] (xwi's
// type), wf_dyn [wd][C] and wf_nrm [C]; kStream: src = the streamed
// pre-activation (kernel 11, xj null) or its sender half zi (kernel 12,
// with the receiver transform xj). W and WT are the tail's stacks (bf16
// values in BF16 mode), gpart G partials of grad_size floats. With n_batch
// samples, sample s's xj, g and (kWin, kDyn) src start s·x_stride elements
// in, its dpre and (kStream) src s·e_stride, its positions (kDyn)
// s·p_stride.
template <class P, typename T, bool BF16, Front F>
__device__ __forceinline__ void edge_bwd_tiles(
    const float* __restrict__ fiber_t, const T* __restrict__ src,
    const T* __restrict__ xj, const float* __restrict__ wf8,
    const float* __restrict__ W, const float* __restrict__ B,
    const float* __restrict__ WT, const float* __restrict__ g, int n_layers,
    const int* __restrict__ send_win, const int* __restrict__ win_base,
    const int* __restrict__ receivers, const int* __restrict__ chunk_block,
    int n_tiles, int e_pad, int edge_block, int window,
    float* __restrict__ gpart, T* __restrict__ dpre,
    const T* __restrict__ pos = nullptr,
    const float* __restrict__ wfd_g = nullptr,
    const float* __restrict__ wfn_g = nullptr, int wd = 0, int n_batch = 1,
    size_t x_stride = 0, size_t e_stride = 0, size_t p_stride = 0) {
  constexpr int C = P::C, TR = P::TR, RW = P::RW, HB = P::HB, V = P::V;
  constexpr bool WIN = F != Front::kStream;
  constexpr bool DYN = F == Front::kDyn;
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [n_layers][TR][C]
  float* d = hs + (size_t)n_layers * TR * C;     // [TR][C] LN out, cotangent
  float* wslab = d + TR * C;                     // [2][KS][C] weight slabs
  float* wf = wslab + 2 * P::KS * C;             // WIN: [8][C] fiber weights
  float* fib = wf + (WIN ? 8 * C : 0);           // WIN: [8][TR] fiber stream
  float* wfd = fib + (WIN ? 8 * TR : 0);         // DYN: [MAX_WD][C] wf_dyn
  float* wfn = wfd + (DYN ? MAX_WD * C : 0);     // DYN: [C] wf_nrm
  float* delta = wfn + (DYN ? C : 0);            // DYN: [MAX_WD][TR] Δ
  float* nrm = delta + (DYN ? MAX_WD * TR : 0);  // DYN: [TR] ‖Δ‖
  int* s_row = reinterpret_cast<int*>(nrm + (DYN ? TR : 0));
  int* s_recv = s_row + TR;
  int* s_loc = s_recv + TR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int total = n_tiles * n_batch;
  const int t_begin = (int)((long long)b * total / G);
  const int t_end = (int)((long long)(b + 1) * total / G);
  const int gsize = grad_size<P>(n_layers, F, wd);
  float* gp = gpart + (size_t)b * gsize;         // dW [n_layers][C][C]
  float* gp_b = gp + (size_t)n_layers * C * C;   // db [n_layers][C]
  float* gp_f = gp_b + (size_t)n_layers * C;     // WIN: dwf8 [8][C]
  float* gp_d = gp_f + 8 * C;                    // DYN: dwf_dyn [wd][C]
  float* gp_n = gp_d + (size_t)wd * C;           // DYN: dwf_nrm [C]
  if constexpr (WIN)  // the fiber weights, rounded in BF16 mode
    for (int i = tid; i < 8 * C; i += NT) wf[i] = BF16 ? round_bf16(wf8[i]) : wf8[i];
  if constexpr (DYN) {  // wf_dyn rounded in BF16 mode, wf_nrm in f32
    for (int i = tid; i < wd * C; i += NT)
      wfd[i] = BF16 ? round_bf16(wfd_g[i]) : wfd_g[i];
    for (int i = tid; i < C; i += NT) wfn[i] = wfn_g[i];
  }
  const DynFiber<T> dyn_all{pos, wd, wfd, wfn, delta, nrm, p_stride};
  bool first = true;  // no live tile yet: the next one stores its partial
  copy_slab<P>(W, 0, wslab);  // the first GEMM's first slab (see gemm_rows)

  for (int t = t_begin; t < t_end; ++t) {
    const int smp = t / n_tiles, t0 = (t - smp * n_tiles) * TR;
    const int ch = t0 / edge_block;
    T* dpre_s = dpre + smp * e_stride;
    const DynFiber<T> dyn = dyn_all.sample(smp);
    if (!tile_slots<P, BF16, F, T>(t0, ch, fiber_t, send_win, win_base,
                                   receivers, chunk_block, e_pad, window,
                                   s_row, s_recv, s_loc, fib, dyn)) {
      // A dead tile: every slot's cotangent is zero.
      for (int i = tid; i < TR * C; i += NT) store(&dpre_s[(size_t)t0 * C + i], 0.f);
      continue;
    }
    const float* g_s = g + smp * x_stride;

    // Recompute: relu(pre) into hs[0], the tail keeping each layer's
    // input, the LayerNorm output into d.
    tile_front<P, T, BF16, F>(t0, src + smp * (WIN ? x_stride : e_stride),
                              xj == nullptr ? xj : xj + smp * x_stride, wf,
                              fib, s_row, s_recv, hs, dyn);
    for (int l = 0; l < n_layers; ++l) {
      float acc[RW][4 * V] = {};
      const float* in = hs + (size_t)l * TR * C;
      gemm_rows<P>(acc, in, W + (size_t)l * C * C,
                   l + 1 < n_layers ? W + (size_t)(l + 1) * C * C
                                    : WT + (size_t)(n_layers - 1) * C * C,
                   wslab);
      const bool last = l == n_layers - 1;
      store_rows<P>(acc, B + l * C, last ? d : hs + (size_t)(l + 1) * TR * C,
                    !last, BF16 && !last);
    }
    __syncthreads();
    // The LayerNorm of each row, then its backward for the edge cotangent
    // g[recv] (rounded to bf16 by the TPU kernel's one-hot dot in BF16
    // mode; zero on masked slots), in the same warp and row; the g rows of
    // each group are loaded first.
    for (int j0 = 0; j0 < RW; j0 += HB) {
      float4 gv[HB][V];
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        const int r = warp + (j0 + j) * NW;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gv[j][v] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s_loc[r] >= 0)
            gv[j][v] = reinterpret_cast<const float4*>(
                g_s + (size_t)s_recv[r] * C)[lane + 32 * v];
        }
      }
#pragma unroll
      for (int j = 0; j < HB; ++j) {
        const int r = warp + (j0 + j) * NW;
        float4 v[V];
#pragma unroll
        for (int vv = 0; vv < V; ++vv)
          v[vv] = reinterpret_cast<float4*>(d + r * C)[lane + 32 * vv];
        const float iv = ln_center<V>(v);
#pragma unroll
        for (int vv = 0; vv < V; ++vv) {
          v[vv].x *= iv; v[vv].y *= iv; v[vv].z *= iv; v[vv].w *= iv;
          if (BF16) {
            gv[j][vv].x = round_bf16(gv[j][vv].x);
            gv[j][vv].y = round_bf16(gv[j][vv].y);
            gv[j][vv].z = round_bf16(gv[j][vv].z);
            gv[j][vv].w = round_bf16(gv[j][vv].w);
          }
        }
        float4 out[V];
        ln_bwd_row<V>(gv[j], v, iv, out);
#pragma unroll
        for (int vv = 0; vv < V; ++vv)
          reinterpret_cast<float4*>(d + r * C)[lane + 32 * vv] = out[vv];
      }
    }

    // Tail layers in reverse: db from the unrounded cotangent, dW and the
    // next cotangent from the rounded one, masked by the layer's input.
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* h = hs + (size_t)l * TR * C;
      __syncthreads();
      for (int c = tid; c < C; c += NT) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s += d[r * C + c];
        gp_b[l * C + c] = first ? s : gp_b[l * C + c] + s;
      }
      // (In f32 nothing writes d before the barrier of dh's first slab.)
      if (BF16) round_tile<P>(d);
      gemm_tn_store<P>(h, d, gp + (size_t)l * C * C, !first);
      float dh[RW][4 * V] = {};
      gemm_rows<P>(dh, d, WT + (size_t)l * C * C,
                   l > 0 ? WT + (size_t)(l - 1) * C * C : W, wslab);
      store_rows_masked<P>(dh, h, d);
    }
    if constexpr (DYN) {
      // dwf_nrm from dpre before any rounding (the TPU kernel's f32 sum).
      __syncthreads();
      for (int c = tid; c < C; c += NT) {
        float s = 0.f;
        for (int r = 0; r < TR; ++r) s = fmaf(nrm[r], d[r * C + c], s);
        gp_n[c] = first ? s : gp_n[c] + s;
      }
    }
    // d is now dpre: stored (bf16 in BF16 mode, which is also the operand
    // of the dwf8 and dwf_dyn sums), then dwf8 = the fiber stream's rows
    // times dpre and, with kDyn, dwf_dyn = Δ's rows times dpre.
    if (BF16) round_tile<P>(d);
    else __syncthreads();
    for (int i = tid; i < TR * C; i += NT) store(&dpre_s[(size_t)t0 * C + i], d[i]);
    if constexpr (WIN)
      for (int k = warp; k < (DYN ? 8 + wd : 8); k += NW)
#pragma unroll
        for (int vv = 0; vv < V; ++vv) {
          const int j0 = lane * 4 + 128 * vv;
          const float* fk = k < 8 ? fib + k * TR : delta + (k - 8) * TR;
          float s[4] = {};
          for (int r = 0; r < TR; ++r) {
            const float f = fk[r];
            const float4 v = *reinterpret_cast<const float4*>(d + r * C + j0);
            s[0] = fmaf(f, v.x, s[0]); s[1] = fmaf(f, v.y, s[1]);
            s[2] = fmaf(f, v.z, s[2]); s[3] = fmaf(f, v.w, s[3]);
          }
          float4* p = reinterpret_cast<float4*>(
              (k < 8 ? gp_f + k * C : gp_d + (k - 8) * C) + j0);
          const float4 o = first ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
          *p = make_float4(o.x + s[0], o.y + s[1], o.z + s[2], o.w + s[3]);
        }
    first = false;
  }
  if (first)  // no live tile in the range: a zero partial
    for (int i = tid; i < gsize; i += NT) gp[i] = 0.f;
  cp_async_wait_all();  // the next tile's first slab, never used
}

// The shared-memory limit of a walk kernel of plan P with front f: what
// its deepest walk holds (max_layers), so one setting serves every depth.
template <class P, typename K>
cudaError_t raise_smem_limit(K kernel, Front f) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<P>(max_layers<P>(f), f));
}

// Blocks of one SM the walk reaches for `kernel` (plan P) at n_layers (the
// launch bounds, registers and shared memory decide), after raising its
// shared-memory limit.
template <class P, typename K>
cudaError_t walk_blocks_per_sm(K kernel, int n_layers, Front f, int* out) {
  const cudaError_t attr = raise_smem_limit<P>(kernel, f);
  if (attr != cudaSuccess) return attr;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, NT, smem_bytes<P>(n_layers, f));
}

}  // namespace tiles
}  // namespace bsms
