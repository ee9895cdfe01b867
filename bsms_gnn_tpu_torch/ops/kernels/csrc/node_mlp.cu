// Kernel 3: the fused GMP node phase (see ../node_mlp.py).
//
//   out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x
//
// One block per 64-row tile; x, the aggregate and every activation stay in
// shared memory through the whole phase.
#include "common.cuh"

using namespace bsms;

namespace {

constexpr size_t SMEM_BYTES = sizeof(float) * (2 * TILE * C + KS * C);

// TX: x's type; TO: the output's (bf16 in BF16 mode, else TX).
template <typename TX, typename TO, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_node_phase_kernel(const TX* __restrict__ x, const float* __restrict__ aggr,
                        const float* __restrict__ W0, const float* __restrict__ b0,
                        const float* __restrict__ W, const float* __restrict__ B,
                        int n_layers, TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [TILE][C] x (f32)
  float* tile = xs + TILE * C;  // [TILE][C] dot operands, then activations
  float* wslab = tile + TILE * C;               // [KS][C] staged weights

  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * TILE;
  for (int i = tid; i < TILE * C; i += THREADS) {
    xs[i] = to_f(x[row0 * C + i]);
    if (BF16) tile[i] = round_bf16(xs[i]);  // x as a dot operand
  }
  // pre = x·Wa + aggr·Wb + b0 (one f32 accumulator over both halves); the
  // residual below adds the unrounded x.
  float acc[8][4] = {};
  tile_gemm<BF16>(acc, BF16 ? tile : xs, W0, wslab);
  for (int i = tid; i < TILE * C; i += THREADS) {
    const float a = aggr[row0 * C + i];
    tile[i] = BF16 ? round_bf16(a) : a;
  }
  tile_gemm<BF16>(acc, tile, W0 + C * C, wslab);
  tile_store(acc, b0, tile, true, BF16);
  tile_mlp_tail<BF16>(tile, W, B, n_layers, wslab);
  for (int i = tid; i < TILE * C; i += THREADS)
    store(&out[row0 * C + i], tile[i] + xs[i]);
}

template <typename TX, typename TO, bool BF16>
int launch(const void* x, const void* aggr, const void* W0, const void* b0,
           const void* W, const void* B, void* out, int n_layers, int n_tiles,
           void* stream) {
  auto kernel = fused_node_phase_kernel<TX, TO, BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<n_tiles, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const TX*)x, (const float*)aggr, (const float*)W0, (const float*)b0,
      (const float*)W, (const float*)B, n_layers, (TO*)out);
  return (int)cudaGetLastError();
}

}  // namespace

#define FUSED_NODE_PHASE(NAME, TX, TO, BF16)                                  \
  extern "C" int NAME(const void* x, const void* aggr, const void* W0,       \
                      const void* b0, const void* W, const void* B,          \
                      void* out, int n_layers, int n_tiles, void* stream) {  \
    return launch<TX, TO, BF16>(x, aggr, W0, b0, W, B, out, n_layers,        \
                                n_tiles, stream);                            \
  }

// f32 compute; bf16 compute on bf16 x; bf16 compute on f32 x (the level-0
// GMP when the encoder runs in f32, `io_dtype="float32"`).
FUSED_NODE_PHASE(fused_node_phase_f32, float, float, false)
FUSED_NODE_PHASE(fused_node_phase_bf16, __nv_bfloat16, __nv_bfloat16, true)
FUSED_NODE_PHASE(fused_node_phase_f32_bf16, float, __nv_bfloat16, true)
