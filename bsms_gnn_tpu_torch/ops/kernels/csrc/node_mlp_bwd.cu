// Kernel 6: the backward of the fused GMP node phase (see ../node_mlp.py),
// with the forward recomputed in the kernel, replacing the TPU kernel
// `bsms_gnn_tpu/ops/pallas/node_mlp.py:125` (`_get_bwd`).
//
// For out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x and its cotangent g:
//   dx = dpre·Waᵀ + g,  daggr = dpre·Wbᵀ              (per row)
//   dWa = xᵀ·dpre, dWb = aggrᵀ·dpre, db0 = Σ dpre, dW[l], db[l]
//
// What bounds it: operations, in true f32 on the CUDA cores (no TF32):
// fifteen 64×128×128 products per 64-row tile (2 + L forward, 2·L in the
// tail's backward, then dx, daggr, dWa, dWb at L = 3), against 2.5 KB of
// rows per row.
//
// What the design does about it: a thread-block cluster of CL CTAs per
// 64-row tile, CTA q owning the SW = C / CL columns [q·SW, (q+1)·SW) of
// every product's output, so the tile's serial chain of products is CL
// times shorter on CL SMs, and a level of n tiles runs CL·n CTAs (the 5k
// airfoil's levels hold 82 tiles down to 1: a block per tile left every
// level on fewer SMs than the card has).
// - Row products (the layers, the cotangents, dx, daggr): CTA q computes
//   its SW output columns of all 64 rows from the full input tile A
//   (64×128 in shared memory, rows padded to AS floats so that the rows a
//   warp reads at once fall on distinct banks), each output summed over k
//   in order by one FMA chain, as kernel 6 always has. The CTA's weight
//   slices (128×SW) are double-buffered with cp.async in the fixed order
//   of the products, the next loading during the current one; in BF16 mode
//   the weights come already rounded to bf16 (stored as f32).
// - The exchange: CTA q writes its output columns into a slice of its own
//   shared memory; after a cluster barrier every CTA copies the CL slices
//   through distributed shared memory into its full tile A. The forward
//   keeps each tail input's own slice (the ReLU masks and the dW operands
//   of the backward), the backward's cotangents alternate between two
//   slices, so one barrier per exchange suffices: a slice is written again
//   only after every peer has passed the barrier that follows its reads.
//   The barrier is split: a CTA arrives once its slice is written and, in
//   the backward, computes the layer's dW before it waits; each thread
//   issues its loads of the CL slices together.
// - The LayerNorm and its backward run on the full last-layer output in
//   every CTA of the cluster (the same code on the same values, so the
//   same result in each), g read whole: no exchange of row statistics.
// - Weight gradients: dW[l] = h_lᵀ·d splits by the rows of dW, the input
//   columns of h_l, so CTA q needs only its own slice of h_l and the full
//   cotangent A: it writes rows [q·SW, (q+1)·SW) of each dW (and its SW
//   columns of each db) into the tile's partial, each element summed over
//   the tile's rows in row order. The CL CTAs' disjoint parts make one
//   partial per cluster, and grad_sum_kernel adds the partials in cluster
//   order: no atomics, the same result from run to run.
// - The partials are capped (the batch axis folds B samples into B·T
//   tiles: at B = 48 the 5k airfoil's level 0 holds 3,936 tiles, whose one
//   330 KB partial each would make 1.3 GB): P = min(T, P_max) clusters
//   (P_max from the host, `node_mlp.p_max`: whole waves of the clusters
//   the card holds at once, at least every B = 1 level's tiles), cluster
//   p walking the tiles [⌊p·T/P⌋, ⌊(p+1)·T/P⌋) in order, the first stored
//   into its partial, each later one added onto it. Where T ≤ P_max each
//   cluster holds one tile, which is the arithmetic of the
//   one-block-per-tile kernel this replaces.
// - Shared memory: A (33 KB), the tail inputs' slices (8 KB each), two
//   exchange slices and two weight slices, about 105 KB at L = 3, so two
//   CTAs fit on an SM.
// The cluster's constants, weight copy, exchange and tile load are
// node_cluster.cuh's, which kernel 3 shares.
#include "backward.cuh"
#include "node_cluster.cuh"

using namespace bsms;
using namespace bsms::node_cluster;

namespace {

constexpr int MIN_BLOCKS = 2;
constexpr int MAX_LAYERS = 3;

// Slices of the tail inputs kept: the L inputs, and at least two (x's and
// aggr's slices at the end).
__host__ __device__ constexpr int n_slices(int n_layers) {
  return n_layers > 2 ? n_layers : 2;
}

// Floats of shared memory: A, the kept slices, two exchange slices, two
// weight slices.
__host__ __device__ constexpr size_t smem_floats(int n_layers) {
  return (size_t)TILE * AS + (size_t)(n_slices(n_layers) + 2) * TILE * SW +
         2 * C * SW;
}

size_t smem_bytes(int n_layers) { return sizeof(float) * smem_floats(n_layers); }

// The weight slice of product i in its fixed order (0, 1: W0's x and aggr
// halves; 2 .. L+1: W[0 .. L-1]; L+2 .. 2L+1: WT[L-1 .. 0]; 2L+2, 2L+3:
// W0ᵀ's x and aggr halves, for dx and daggr): its first element's address
// and its row stride.
struct Weights {
  const float* W0;   // [2C][C]
  const float* W;    // [L][C][C]
  const float* WT;   // [L][C][C], each transposed
  const float* W0T;  // [C][2C]
  int n_layers;
  __device__ __forceinline__ const float* src(int i, int& ld) const {
    const size_t cc = (size_t)C * C;
    ld = C;
    if (i < 2) return W0 + i * cc;
    if (i < 2 + n_layers) return W + (i - 2) * cc;
    if (i < 2 + 2 * n_layers) return WT + (2 * n_layers + 1 - i) * cc;
    ld = 2 * C;
    return W0T + (i - 2 - 2 * n_layers) * C;
  }
};

// Issues the copy of product i's slice (C rows by the CTA's SW columns)
// into buffer i mod 2 of `wbuf` (cp.async, one commit group).
__device__ __forceinline__ void copy_slice(const Weights& w, int i, int q,
                                           float* wbuf) {
  int ld;
  const float* src = w.src(i, ld);
  copy_cols(src, ld, C, q, wbuf + (i & 1) * C * SW);
}

// acc[i][j] += Σ_k A[(2·rg + i)·AS + k] · Wslice[k][4·cg + j] over k < C, in
// k order, rg = tid / 8, cg = tid % 8: product i's output columns of the 64
// rows. Waits for slice i, then issues slice i + 1 (when there is one)
// into the other buffer: the barrier between them also orders the callers'
// writes of A before the reads and every read of the other buffer (the
// previous product) before it is overwritten.
__device__ __forceinline__ void row_product(float (&acc)[2][4], const float* A,
                                            const Weights& w, int i,
                                            int n_products, int q,
                                            float* wbuf) {
  const int rg = threadIdx.x >> 3, cg4 = 4 * (threadIdx.x & 7);
  cp_async_wait_all();
  __syncthreads();
  if (i + 1 < n_products) copy_slice(w, i + 1, q, wbuf);
  const float* ws = wbuf + (i & 1) * C * SW;
#pragma unroll 4
  for (int k = 0; k < C; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + (2 * rg) * AS + k);
    const float4 a1 = *reinterpret_cast<const float4*>(A + (2 * rg + 1) * AS + k);
    const float a[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 v = *reinterpret_cast<const float4*>(ws + (k + kk) * SW + cg4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[r][0] = fmaf(a[r][kk], v.x, acc[r][0]);
        acc[r][1] = fmaf(a[r][kk], v.y, acc[r][1]);
        acc[r][2] = fmaf(a[r][kk], v.z, acc[r][2]);
        acc[r][3] = fmaf(a[r][kk], v.w, acc[r][3]);
      }
    }
  }
}

// out (a TILE×SW slice) = acc + bias[q·SW ..], optionally ReLU'd and
// rounded to bf16, in row_product's layout.
__device__ __forceinline__ void store_slice(const float (&acc)[2][4],
                                            const float* __restrict__ bias,
                                            int q, float* out, bool relu,
                                            bool to_bf16) {
  const int rg = threadIdx.x >> 3, cg4 = 4 * (threadIdx.x & 7);
  const float4 b = *reinterpret_cast<const float4*>(bias + q * SW + cg4);
  const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[r][j] + bb[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
      if (to_bf16) v[j] = round_bf16(v[j]);
    }
    *reinterpret_cast<float4*>(out + (2 * rg + r) * SW + cg4) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// out = acc ⊙ (mask > 0) in row_product's layout (the ReLU's backward; mask
// is the layer input's own slice).
__device__ __forceinline__ void store_slice_masked(const float (&acc)[2][4],
                                                   const float* mask,
                                                   float* out) {
  const int rg = threadIdx.x >> 3, cg4 = 4 * (threadIdx.x & 7);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = (2 * rg + r) * SW + cg4;
    const float4 m = *reinterpret_cast<const float4*>(mask + o);
    *reinterpret_cast<float4*>(out + o) = make_float4(
        m.x > 0.f ? acc[r][0] : 0.f, m.y > 0.f ? acc[r][1] : 0.f,
        m.z > 0.f ? acc[r][2] : 0.f, m.w > 0.f ? acc[r][3] : 0.f);
  }
}

// Columns [q·SW, (q+1)·SW) of a TILE×C tile of a row-major [n, C] array
// into a TILE×SW slice, rounded to bf16 in BF16 mode.
template <typename T, bool BF16>
__device__ __forceinline__ void load_slice(const T* __restrict__ src, int q,
                                           float* out) {
  for (int i = threadIdx.x; i < TILE * SW; i += NT) {
    const float v = to_f(src[(size_t)(i / SW) * C + q * SW + i % SW]);
    out[i] = BF16 ? round_bf16(v) : v;
  }
}

// dst[(q·SW + i)·C + j] (+)= Σ_r h[r·SW + i] · A[r·AS + j] over the TILE rows
// in row order: rows [q·SW, (q+1)·SW) of the [C, C] product hᵀ·A, h the
// CTA's TILE×SW slice, A the full tile; stored, or with `add` added onto
// dst (loaded before the product, so that their latency hides behind it).
// Thread t takes rows 8·(t / 64) .. +7 and columns 2·(t % 64), +1: a warp's
// h reads are one broadcast, its A reads 256 contiguous bytes.
__device__ __forceinline__ void weight_grad(const float* h, const float* A,
                                            int q, float* dst, bool add) {
  const int i0 = 8 * (threadIdx.x >> 6), j0 = 2 * (threadIdx.x & 63);
  float2 old[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    old[i] = add ? *reinterpret_cast<const float2*>(
                       dst + (size_t)(q * SW + i0 + i) * C + j0)
                 : make_float2(0.f, 0.f);
  float acc[8][2] = {};
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 h0 = *reinterpret_cast<const float4*>(h + r * SW + i0);
    const float4 h1 = *reinterpret_cast<const float4*>(h + r * SW + i0 + 4);
    const float2 b = *reinterpret_cast<const float2*>(A + r * AS + j0);
    const float a[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
      acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float2*>(dst + (size_t)(q * SW + i0 + i) * C + j0) =
        add ? make_float2(old[i].x + acc[i][0], old[i].y + acc[i][1])
            : make_float2(acc[i][0], acc[i][1]);
}

// out[q·SW + c] (+)= Σ_r A[r·AS + q·SW + c] over the TILE rows in row order,
// by the first SW threads.
__device__ __forceinline__ void col_sums(const float* A, int q, float* out,
                                         bool add) {
  if (threadIdx.x < SW) {
    float s = 0.f;
    for (int r = 0; r < TILE; ++r) s += A[r * AS + q * SW + threadIdx.x];
    out[q * SW + threadIdx.x] = add ? out[q * SW + threadIdx.x] + s : s;
  }
}

// Rounds the full tile to bf16 in place, between two block barriers.
__device__ __forceinline__ void round_full(float* A) {
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * C; i += NT) {
    float* p = A + (i / C) * AS + i % C;
    *p = round_bf16(*p);
  }
  __syncthreads();
}

// TX: x's type (dx is stored in it).
template <typename TX, bool BF16>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, MIN_BLOCKS)
fused_node_phase_bwd_kernel(const TX* __restrict__ x,
                            const float* __restrict__ aggr,
                            const float* __restrict__ W0,
                            const float* __restrict__ b0,
                            const float* __restrict__ W,
                            const float* __restrict__ B,
                            const float* __restrict__ W0T,
                            const float* __restrict__ WT,
                            const float* __restrict__ g, int n_layers,
                            int n_tiles, TX* __restrict__ dx,
                            float* __restrict__ daggr,
                            float* __restrict__ gpart) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);  // [TILE][AS] full tile
  float* hq = A + TILE * AS;                    // [n_slices][TILE][SW]
  float* E = hq + (size_t)n_slices(n_layers) * TILE * SW;  // [2][TILE][SW]
  float* wbuf = E + 2 * TILE * SW;              // [2][C][SW] weight slices

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = blockIdx.x / CL, n_parts = gridDim.x / CL;
  const size_t cc = (size_t)C * C;
  // Partial layout: dWa, dWb, dW[n_layers], db0, db[n_layers].
  float* gp = gpart + part * ((2 + n_layers) * cc + (1 + n_layers) * C);
  float* gp_b0 = gp + (2 + n_layers) * cc;
  const Weights w{W0, W, WT, W0T, n_layers};
  const int n_products = 4 + 2 * n_layers;
  const int t_begin = (int)((long long)part * n_tiles / n_parts);
  const int t_end = (int)((long long)(part + 1) * n_tiles / n_parts);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const bool add = tile > t_begin;  // the first tile stores the partial
    const size_t row0 = (size_t)tile * TILE;
    const TX* xt = x + row0 * C;
    const float* at = aggr + row0 * C;
    int prod = 0;
    copy_slice(w, 0, q, wbuf);

    // Recompute as kernel 3 does: relu(x·Wa + aggr·Wb + b0), one accumulator
    // over both halves; this CTA's columns into hq[0], then the full h_0.
    {
      float acc[2][4] = {};
      load_full<TX, BF16>(xt, A);
      row_product(acc, A, w, prod++, n_products, q, wbuf);
      __syncthreads();
      load_full<float, BF16>(at, A);
      row_product(acc, A, w, prod++, n_products, q, wbuf);
      store_slice(acc, b0, q, hq, true, BF16);
    }
    exchange(cluster, hq, A);
    // The tail: each layer's input slice kept; the last layer's output
    // (unrounded) through E[0].
    for (int l = 0; l < n_layers; ++l) {
      float acc[2][4] = {};
      row_product(acc, A, w, prod++, n_products, q, wbuf);
      const bool last = l == n_layers - 1;
      float* out = last ? E : hq + (size_t)(l + 1) * TILE * SW;
      store_slice(acc, B + l * C, q, out, !last, BF16 && !last);
      exchange(cluster, out, A);
    }
    int eb = 1;  // the exchange slice the next cotangent takes
    __syncthreads();

    // The LayerNorm of each row, then its backward for g (f32, as on the
    // TPU), in place in A: warp w takes rows w, w + 8, ..., its g rows
    // loaded first.
    constexpr int RPW = TILE / (NT / 32);  // rows per warp
    float4 gv[RPW];
  #pragma unroll
    for (int i = 0; i < RPW; ++i)
      gv[i] = reinterpret_cast<const float4*>(
          g + (row0 + warp + i * (NT / 32)) * C)[lane];
  #pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * (NT / 32);
      float4 v = *reinterpret_cast<float4*>(A + r * AS + 4 * lane);
      const float mean = warp_sum(v.x + v.y + v.z + v.w) / C;
      v.x -= mean; v.y -= mean; v.z -= mean; v.w -= mean;
      const float var = warp_sum(v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w) / C;
      const float iv = 1.0f / sqrtf(var + LN_EPS);
      v.x *= iv; v.y *= iv; v.z *= iv; v.w *= iv;
      *reinterpret_cast<float4*>(A + r * AS + 4 * lane) = ln_bwd(gv[i], v, iv);
    }

    // Tail layers in reverse: db from the unrounded cotangent, dW and the
    // next cotangent from the rounded one, masked by the layer's input. The
    // next cotangent's slice goes out first; dW's product then overlaps the
    // cluster barrier of its exchange.
    for (int l = n_layers - 1; l >= 0; --l) {
      const float* h = hq + (size_t)l * TILE * SW;
      __syncthreads();
      col_sums(A, q, gp_b0 + C + l * C, add);
      if (BF16) round_full(A);
      float dh[2][4] = {};
      row_product(dh, A, w, prod++, n_products, q, wbuf);
      float* out = E + eb * TILE * SW;
      store_slice_masked(dh, h, out);
      cluster_arrive();
      weight_grad(h, A, q, gp + (2 + l) * cc, add);
      __syncthreads();  // every read of A done before the exchange's writes
      exchange_wait(cluster, out, A);
      eb ^= 1;
    }

    // A is dpre: db0 from it unrounded, then the rounded operand of the rest.
    __syncthreads();
    col_sums(A, q, gp_b0, add);
    if (BF16) round_full(A);
    const int rg = tid >> 3, cg4 = 4 * (tid & 7);
    {
      float acc[2][4] = {};
      row_product(acc, A, w, prod++, n_products, q, wbuf);
  #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t o = (row0 + 2 * rg + r) * C + q * SW + cg4;
        const float4 gv = *reinterpret_cast<const float4*>(g + o);
        store(&dx[o], acc[r][0] + gv.x);
        store(&dx[o + 1], acc[r][1] + gv.y);
        store(&dx[o + 2], acc[r][2] + gv.z);
        store(&dx[o + 3], acc[r][3] + gv.w);
      }
    }
    {
      float acc[2][4] = {};
      row_product(acc, A, w, prod++, n_products, q, wbuf);
  #pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t o = (row0 + 2 * rg + r) * C + q * SW + cg4;
        *reinterpret_cast<float4*>(daggr + o) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    // dWa and dWb: this CTA's columns of x and of aggr as the left operands,
    // in the kept slices (free now: no peer reads them any more).
    load_slice<TX, BF16>(xt, q, hq);
    load_slice<float, BF16>(at, q, hq + TILE * SW);
    __syncthreads();
    weight_grad(hq, A, q, gp, add);
    weight_grad(hq + TILE * SW, A, q, gp + cc, add);
    // No CTA leaves, or starts its next tile, while a peer may still read
    // its shared memory.
    cluster.sync();
  }
}

// (CTAs per SM, clusters on the card at once) of the kernel at n_layers,
// as the card's occupancy calculator reports them: the host sizes the cap
// on the partials in whole waves of clusters (node_mlp.p_max).
template <typename TX, bool BF16>
int occupancy(int n_layers, int* blocks_per_sm, int* clusters) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  auto kernel = fused_node_phase_bwd_kernel<TX, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_LAYERS));
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, NT, smem_bytes(n_layers));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(n_layers);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <typename TX, bool BF16>
int launch(const void* x, const void* aggr, const void* W0, const void* b0,
           const void* W, const void* B, const void* W0T, const void* WT,
           const void* g, void* gpart, int n_layers, int n_tiles, int n_parts,
           void* dx, void* daggr, void* grads, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_tiles < 1 || n_parts < 1 ||
      n_parts > n_tiles)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_node_phase_bwd_kernel<TX, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(MAX_LAYERS));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<n_parts * CL, NT, smem_bytes(n_layers), s>>>(
      (const TX*)x, (const float*)aggr, (const float*)W0, (const float*)b0,
      (const float*)W, (const float*)B, (const float*)W0T, (const float*)WT,
      (const float*)g, n_layers, n_tiles, (TX*)dx, (float*)daggr,
      (float*)gpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int size = (2 + n_layers) * C * C + (1 + n_layers) * C;
  return (int)launch_grad_sum((const float*)gpart, n_parts, size,
                              (float*)grads, s);
}

}  // namespace

#define FUSED_NODE_PHASE_BWD(NAME, TX, BF16)                                   \
  extern "C" int NAME##_occupancy(int n_layers, int* blocks_per_sm,           \
                                  int* clusters) {                            \
    return occupancy<TX, BF16>(n_layers, blocks_per_sm, clusters);            \
  }                                                                           \
  extern "C" int NAME(const void* x, const void* aggr, const void* W0,        \
                      const void* b0, const void* W, const void* B,           \
                      const void* W0T, const void* WT, const void* g,         \
                      void* gpart, int n_layers, int n_tiles, int n_parts,    \
                      void* dx, void* daggr, void* grads, void* stream) {     \
    return launch<TX, BF16>(x, aggr, W0, b0, W, B, W0T, WT, g, gpart,         \
                            n_layers, n_tiles, n_parts, dx, daggr, grads,     \
                            stream);                                          \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (as kernel 3).
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_f32, float, false)
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_bf16, __nv_bfloat16, true)
FUSED_NODE_PHASE_BWD(fused_node_phase_bwd_f32_bf16, float, true)
