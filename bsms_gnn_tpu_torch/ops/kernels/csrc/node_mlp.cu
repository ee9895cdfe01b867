// Kernel 3: the fused GMP node phase (see ../node_mlp.py).
//
//   out = LN(tail(relu(x·Wa + aggr·Wb + b0))) + x
//
// One block per 64-row tile (`node_phase.cuh`); the aggregate rows are
// read from device memory.
#include "node_phase.cuh"

using namespace bsms;

namespace {

constexpr size_t SMEM_BYTES = node_phase_smem<8>();

// TX: x's type; TO: the output's (bf16 in BF16 mode, else TX).
template <typename TX, typename TO, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_node_phase_kernel(const TX* __restrict__ x, const float* __restrict__ aggr,
                        const float* __restrict__ W0, const float* __restrict__ b0,
                        const float* __restrict__ W, const float* __restrict__ B,
                        int n_layers, TO* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const size_t row0 = (size_t)blockIdx.x * TILE;
  auto fill_aggr = [&](float* tile) {
    for (int i = threadIdx.x; i < TILE * C; i += THREADS) {
      const float a = aggr[row0 * C + i];
      tile[i] = BF16 ? round_bf16(a) : a;
    }
  };
  node_phase_tile<TX, TO, BF16, 8>(x, fill_aggr, W0, b0, W, B, n_layers, out,
                                   row0, reinterpret_cast<float*>(smem4));
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
