// The row-ordered gather of kernels 1 (windowed.cu), 2 (compact_resid.cu),
// 7 (windowed_send.cu), 8 (segment_sum.cu), 9 (segment_sum_accum.cu) and 15
// (subwin_conv.cu), and of the edge tile walks' aggregates and dxj
// (kernels 4, 5 and 11-14 and their backwards: kernel 7's front over the
// receiver lists):
//
//   out[dst(k)] (= or +=) Σ_{i ∈ [row_ptr[k], row_ptr[k+1])} w(e_i) · x[row(e_i)]
//
// over host-built lists, list k in the order of its positions i, with e_i
// the slot at position i. Each entry point picks its fronts at compile
// time:
// - the source (`Src`): e_i (`slots[i]`, or i itself where each list is a
//   range of x's rows: kernel 2), the value row row(e) (the entry point's
//   resolver from its layout tables, or e itself: kernels 2, 4, 5 and 7)
//   and, when WEIGHTED (kernels 1 and 15), w(e) = ew[e], rounded to bf16
//   in BF16 mode (the product with a bf16 row is then exact in f32). An
//   unweighted source adds the row as it is (bf16 widens to f32 exactly);
// - the destination (`Dst`): the output row dst(k) (k itself, or rows[k]:
//   kernel 2) and how a sum is written: stored, a list with no position
//   giving a zero row (kernels 1, 4, 5, 7, 8, 9's store form, 15), added
//   onto the row's value, read once and written once (kernel 2), or added
//   onto the same row of another array, which is read once and left as it
//   is (kernel 9); rows no list names are not touched.
// The sum is in f32.
//
// A batch of samples over one layout (the batch axis of a shared mesh):
// blockIdx.y is the sample b, and x and the output (with kernel 2's
// accumulator, which is the output) move by b times their per-sample
// strides (elements, 64-bit), so the grid's y extent is the batch and the
// lists, their order and every sum are the same for each sample as in a
// call on that sample alone. An entry point off the batched path (kernels
// 8, 9 and 15, whose AddOnto reads acc unmoved) launches gridDim.y = 1
// with zero strides.
//
// Blocks of GATHER_WARPS warps. The first ceil(n_rows / (GATHER_WARPS ·
// ROWS)) blocks give each warp ROWS consecutive lists (WARP_ROWS = 4; 1 for
// kernel 9, whose lists hold a few slots each): the warp walks their
// concatenation (one contiguous range of positions), 32 positions at a
// time, and writes each row when its list ends. A list of more than
// `piece` positions (P = 32 from the host) is left out of that walk and
// gets a block of its own, one of the blocks after those, in the order of
// `long_rows` (hierarchy.py::long_rows): it is cut into pieces of P
// positions, warp w sums pieces w, w + GATHER_WARPS, ... in that order,
// each piece from zero, and warp 0 adds the warps' sums in warp order
// through 4 KB of shared memory. Every addition's order is fixed by the
// tables alone, so the result does not depend on scheduling; no atomics.
//
// A walk: the lanes resolve 32 positions' slots and rows (and weights) at
// once (one position per lane), then every lane loads 4 columns of each
// listed row (16 bytes in f32, 8 in bf16), the rows of 4 (f32) or 8 (bf16)
// positions in flight before their adds, and sums in registers in list
// order. A warp of ROWS short lists pays the chain of dependent loads
// (row_ptr → slots → the resolver's tables → x) once for all of them; an
// adding destination loads its rows' values beside the walk's first loads.
#pragma once

#include "row_sum.cuh"  // add4

namespace bsms {

constexpr int GATHER_WARPS = THREADS / 32;  // warps of a block
constexpr int WARP_ROWS = 4;                // short lists of a warp
constexpr unsigned FULL_MASK = 0xffffffffu;

// A lane's 4 columns of a row as loaded (float4, or 4 bf16 in a uint2) and
// widened to f32, UNROLL of them in flight per warp. With GATHER_MIN_BLOCKS
// blocks per SM (64 registers a thread) these read fastest on an H100 at
// the 5k meshes' layouts, where few warps run and a warp's own loads in
// flight set the time, and near the fastest f32 on a 1M-node level, where
// resident warps do (PERF.md §6).
constexpr int GATHER_MIN_BLOCKS = 4;
// The unweighted gathers (kernels 2 and 7) run at 2 blocks per SM (up to
// 128 registers a thread): at 64 they spill (kernel 2 also holds its rows'
// values) and ran slower on an H100 at every shape chip_smoke.py gives
// them, where a launch holds at most a few hundred blocks.
constexpr int GATHER_SUM_MIN_BLOCKS = 2;
template <typename T> struct Lane4;
template <> struct Lane4<float> {
  using raw = float4;
  static constexpr int UNROLL = 4;
  static __device__ __forceinline__ float4 widen(float4 v) { return v; }
};
template <> struct Lane4<__nv_bfloat16> {
  using raw = uint2;
  static constexpr int UNROLL = 8;
  static __device__ __forceinline__ float4 widen(uint2 u) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

__device__ __forceinline__ void fma4(float4& s, float w, const float4 v) {
  s.x = fmaf(w, v.x, s.x); s.y = fmaf(w, v.y, s.y);
  s.z = fmaf(w, v.z, s.z); s.w = fmaf(w, v.w, s.w);
}

// Sources. Slots listed in `slots`, weighted by ew, each row found by the
// entry point's resolver (kernels 1 and 15).
template <typename Row>
struct WeightedSlots {
  static constexpr bool WEIGHTED = true;
  const int* slots;
  const float* ew;
  Row row_of;
  __device__ __forceinline__ int slot(int i) const { return __ldg(slots + i); }
  __device__ __forceinline__ int row(int e) const { return row_of(e); }
  __device__ __forceinline__ float weight(int e) const { return __ldg(ew + e); }
};
// Slots listed in `slots`, each adding its own row of x (kernel 7, and
// kernels 4 and 5 over the receiver lists).
struct ListedSlots {
  static constexpr bool WEIGHTED = false;
  const int* slots;
  __device__ __forceinline__ int slot(int i) const { return __ldg(slots + i); }
  __device__ __forceinline__ int row(int e) const { return e; }
};
// Each list a range of x's rows, position i adding row i (kernel 2).
struct RangeRows {
  static constexpr bool WEIGHTED = false;
  __device__ __forceinline__ int slot(int i) const { return i; }
  __device__ __forceinline__ int row(int e) const { return e; }
};

// Destinations. List k's sum stored into row k (kernels 1, 4, 5's dxj, 7,
// 15).
struct StoreRows {
  static constexpr bool ADD = false;
};
// List k's sum added onto row rows[k] (kernel 2).
struct AddToRows {
  static constexpr bool ADD = true;
  const int* rows;
  __device__ __forceinline__ int row(int k) const { return __ldg(rows + k); }
  // Where the row's value is read: the output itself.
  __device__ __forceinline__ const float4* base(const float4* out) const {
    return out;
  }
};
// List k's sum added onto row k of acc, written to row k of the output
// (kernel 9: acc stays as it is).
struct AddOnto {
  static constexpr bool ADD = true;
  const float* acc;
  __device__ __forceinline__ int row(int k) const { return k; }
  __device__ __forceinline__ const float4* base(const float4*) const {
    return reinterpret_cast<const float4*>(acc);
  }
};

// One warp's walk over `n_total` positions: slot_at(i, pos, k) sets the
// list position of the i-th and the index k (non-decreasing in i) of the
// list it belongs to; flush(k, s) is called for k = 0, 1, ..., n_rows − 1
// in order, with list k's sum in list order (zero for an empty list).
template <bool BF16, typename T, typename Src, typename SlotAt,
          typename Flush>
__device__ __forceinline__ void gather_walk(const T* __restrict__ x,
                                            const Src& src, int n_total,
                                            int n_rows, const SlotAt& slot_at,
                                            const Flush& flush, int lane) {
  using L = Lane4<T>;
  constexpr int U = L::UNROLL;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur = 0;
  for (int i0 = 0; i0 < n_total; i0 += 32) {
    const int n = min(32, n_total - i0);
    int row = 0, k = 0;
    float w = 0.f;
    if (lane < n) {
      int at;
      slot_at(i0 + lane, at, k);
      const int e = src.slot(at);
      row = src.row(e);
      if constexpr (Src::WEIGHTED) {
        w = src.weight(e);
        if (BF16) w = round_bf16(w);
      }
    }
    for (int j = 0; j < n; j += U) {
      typename L::raw v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = __shfl_sync(FULL_MASK, row, (j + u) & 31);
        if (j + u < n)
          v[u] = *reinterpret_cast<const typename L::raw*>(
              x + (size_t)r * C + 4 * lane);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float wu = 1.f;
        if constexpr (Src::WEIGHTED)
          wu = __shfl_sync(FULL_MASK, w, (j + u) & 31);
        const int ku = __shfl_sync(FULL_MASK, k, (j + u) & 31);
        if (j + u < n) {
          while (cur < ku) {
            flush(cur++, s);
            s = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          if constexpr (Src::WEIGHTED)
            fma4(s, wu, L::widen(v[u]));
          else
            add4(s, L::widen(v[u]));
        }
      }
    }
  }
  while (cur < n_rows) {
    flush(cur++, s);
    s = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The body of a gather kernel (see the note above) over n_rows lists, ROWS
// short lists a warp: out is f32 with rows of C; sample blockIdx.y's x and
// out start x_stride and out_stride elements after the previous sample's.
template <bool BF16, int ROWS = WARP_ROWS, typename T, typename Src,
          typename Dst>
__device__ __forceinline__ void gather_rows(const T* __restrict__ x,
                                            const Src& src, const Dst& dst_of,
                                            const int* __restrict__ row_ptr,
                                            const int* __restrict__ long_rows,
                                            int n_rows, int piece,
                                            float* __restrict__ out,
                                            size_t x_stride = 0,
                                            size_t out_stride = 0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  x += blockIdx.y * x_stride;
  out += blockIdx.y * out_stride;
  float4* dst = reinterpret_cast<float4*>(out);
  const int n_short = (n_rows + GATHER_WARPS * ROWS - 1) /
                      (GATHER_WARPS * ROWS);
  if ((int)blockIdx.x < n_short) {
    // ROWS lists; the long ones are left to their own blocks.
    const int r0 = (blockIdx.x * GATHER_WARPS + warp) * ROWS;
    if (r0 >= n_rows) return;
    const int p = __ldg(row_ptr + min(r0 + min(lane, ROWS), n_rows));
    int o = 0;  // an adding destination's row of list r0 + lane
    if constexpr (Dst::ADD)
      o = dst_of.row(min(r0 + min(lane, ROWS - 1), n_rows - 1));
    int first[ROWS], at[ROWS + 1];  // list offset, walk offset
    unsigned short_rows = 0;
    at[0] = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      first[k] = __shfl_sync(FULL_MASK, p, k);
      const int len = __shfl_sync(FULL_MASK, p, k + 1) - first[k];
      const bool keep = r0 + k < n_rows && len <= piece;
      short_rows |= (unsigned)keep << k;
      at[k + 1] = at[k] + (keep ? len : 0);
    }
    // An adding destination's rows and their values, loaded before the walk.
    int orow[ROWS];
    float4 base[ROWS];
    if constexpr (Dst::ADD) {
      const float4* from = dst_of.base(dst);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        orow[k] = __shfl_sync(FULL_MASK, o, k);
        if (short_rows >> k & 1u)
          base[k] = from[(size_t)orow[k] * (C / 4) + lane];
      }
    }
    const auto slot_at = [&](int i, int& pos, int& k) {
      k = 0;
      pos = first[0] + i;
#pragma unroll
      for (int kk = 1; kk < ROWS; ++kk)
        if (i >= at[kk]) {
          k = kk;
          pos = first[kk] + i - at[kk];
        }
    };
    const auto flush = [&](int k, float4 s) {
      if (!(short_rows >> k & 1u)) return;
      if constexpr (Dst::ADD) {
#pragma unroll
        for (int kk = 0; kk < ROWS; ++kk)
          if (kk == k) {
            add4(s, base[kk]);
            dst[(size_t)orow[kk] * (C / 4) + lane] = s;
          }
      } else {
        dst[(size_t)(r0 + k) * (C / 4) + lane] = s;
      }
    };
    gather_walk<BF16>(x, src, at[ROWS], ROWS, slot_at, flush, lane);
    return;
  }
  // One long list, in pieces of `piece` positions over the block's warps.
  __shared__ float4 part[GATHER_WARPS][32];
  const int r = long_rows[blockIdx.x - n_short];
  int o = r;
  if constexpr (Dst::ADD) o = dst_of.row(r);
  const int a = row_ptr[r], b = row_ptr[r + 1];
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = a + warp * piece; p < b; p += GATHER_WARPS * piece) {
    const auto slot_at = [&](int i, int& pos, int& k) {
      pos = p + i;
      k = 0;
    };
    const auto flush = [&](int, const float4 t) { add4(s, t); };
    gather_walk<BF16>(x, src, min(piece, b - p), 1, slot_at, flush, lane);
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < GATHER_WARPS; ++w) add4(s, part[w][lane]);
    if constexpr (Dst::ADD)
      add4(s, dst_of.base(dst)[(size_t)o * (C / 4) + lane]);
    dst[(size_t)o * (C / 4) + lane] = s;
  }
}

// The receiver gather of kernel 4's aggregate (fused_gmp.cu) and kernel
// 5's dxj (fused_gmp_bwd.cu): out[n] = Σ rows[e] over receiver row n's
// listed slots (`win_row_ptr`, `win_row_slots`, `win_long`), in list
// order (a bf16 row widens exactly to f32); a row with no slot comes out
// zero. Batched (kernels 4 and 5): sample blockIdx.y's rows and out
// start rows_stride and out_stride elements after the previous sample's
// (the other tile walks' entries launch one sample with zero strides).
template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS, GATHER_SUM_MIN_BLOCKS)
recv_gather_kernel(const T* __restrict__ rows,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ row_slots,
                   const int* __restrict__ long_rows, int n_rows, int piece,
                   float* __restrict__ out, size_t rows_stride,
                   size_t out_stride) {
  gather_rows<BF16>(rows, ListedSlots{row_slots}, StoreRows{}, row_ptr,
                    long_rows, n_rows, piece, out, rows_stride, out_stride);
}

// Blocks of a gather launch over n_rows lists, n_long of them long, `rows`
// short lists a warp.
inline int gather_blocks(int n_rows, int n_long, int rows = WARP_ROWS) {
  return (n_rows + GATHER_WARPS * rows - 1) / (GATHER_WARPS * rows) + n_long;
}

// The grid of a gather launch over n_batch samples (blockIdx.y the
// sample).
inline dim3 gather_grid(int n_rows, int n_long, int n_batch = 1,
                        int rows = WARP_ROWS) {
  return dim3(gather_blocks(n_rows, n_long, rows), n_batch);
}

// The largest batch a gather launch takes (the grid's y extent).
constexpr int MAX_BATCH = 65535;

}  // namespace bsms
