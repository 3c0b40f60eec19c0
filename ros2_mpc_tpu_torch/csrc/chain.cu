// K3: dependent chains of one op per element, the measuring kernel of the
// roofline (ros2_mpc_tpu_torch/utils/roofline.py).
//
// Replaces the TPU kernel ros2_mpc_tpu/utils/roofline.py::_chain_rate (its
// `kernel`, launched by pl.pallas_call): n_steps * UNROLL dependent
// applications of one map, independently for each element of a float32
// block. The maps, and the ops each step counts:
//   fma     x * 1.0000001 + 1e-9, one fused multiply-add   1
//   exp     exp(-x)                                        1
//   log     log(x) + 2                                     1
//   sincos  cos x + 0.5 sin x                              2
// Each stays bounded (fixed points ~0.567 for exp, ~3.15 for log, ~0.98 for
// sincos; fma grows by 2^-23 a step).
//
// It is built into the same library as K1 and K2, under the same flags
// (_build.py: -O3 -fmad=false, no --use_fast_math), and its ops are written
// as the solver writes them: expf and logf as in common.cuh, and sincos
// through sincos_sel with fast == 0, the stock sincosf. So the rates it
// measures are those of the instructions the solver kernels execute. Under
// -fmad=false a written x * a + b would become FMUL + FADD; the FMA step is
// __fmaf_rn, which the flag does not touch.
//
// What bounds it: issue of dependent FP32 (or SFU) instructions, never
// bytes (one load and one store per element). One element is one dependent
// chain, so latency is hidden by resident warps alone: with a ~4-cycle FFMA
// latency each SM sub-partition needs 4 warps in flight, 16 per SM. The
// caller picks the geometry (utils/roofline.py: 1056 x 256 elements in
// 256-thread blocks for the peaks, 64 warps on each of 132 SMs; the
// solver's own 4096 elements in 64-thread blocks for the loop overhead).
//
// The trip loop stays a loop: n_steps is a runtime argument and the outer
// loop carries `#pragma unroll 1`, so at UNROLL == 1 each trip is one op
// plus the loop's own counter, compare and branch, which is what
// measure_loop_overhead subtracts.
#include "common.cuh"

namespace mpc {

enum ChainOp : int { kChainFma = 0, kChainExp = 1, kChainLog = 2, kChainSincos = 3 };

template <int OP>
__device__ __forceinline__ float chain_step(float x) {
  if constexpr (OP == kChainFma) {
    return __fmaf_rn(x, 1.0000001f, 1e-9f);
  } else if constexpr (OP == kChainExp) {
    return expf(-x);
  } else if constexpr (OP == kChainLog) {
    return logf(x) + 2.f;
  } else {
    float c, s;
    sincos_sel(0, x, &c, &s);
    return c + 0.5f * s;
  }
}

template <int OP, int UNROLL>
__global__ void chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                             int n_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v = chain_step<OP>(v);
  }
  out[i] = v;
}

template <int OP>
cudaError_t launch_chain(const float* x, float* out, int n, int n_steps, int unroll, int block,
                         cudaStream_t stream) {
  const int grid = (n + block - 1) / block;
  if (unroll == 1) {
    chain_kernel<OP, 1><<<grid, block, 0, stream>>>(x, out, n, n_steps);
  } else if (unroll == 16) {
    chain_kernel<OP, 16><<<grid, block, 0, stream>>>(x, out, n, n_steps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace mpc

extern "C" {

// Launch K3 on `stream`: out[i] = n_steps * unroll applications of map `op`
// (0 fma, 1 exp, 2 log, 3 sincos) to x[i], i < n, one element per thread,
// `block` threads a block; unroll is 1 or 16. Returns the cudaError_t of the
// launch.
int mpc_chain_launch(const float* x, float* out, int n, int n_steps, int op, int unroll,
                     int block, void* stream) {
  if (n < 1 || n_steps < 0 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case mpc::kChainFma:
      return static_cast<int>(mpc::launch_chain<mpc::kChainFma>(x, out, n, n_steps, unroll, block, s));
    case mpc::kChainExp:
      return static_cast<int>(mpc::launch_chain<mpc::kChainExp>(x, out, n, n_steps, unroll, block, s));
    case mpc::kChainLog:
      return static_cast<int>(mpc::launch_chain<mpc::kChainLog>(x, out, n, n_steps, unroll, block, s));
    case mpc::kChainSincos:
      return static_cast<int>(
          mpc::launch_chain<mpc::kChainSincos>(x, out, n, n_steps, unroll, block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
