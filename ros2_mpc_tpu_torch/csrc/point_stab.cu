// K1: whole-solver bank kernel for unicycle point stabilization.
//
// Replaces the TPU kernel ros2_mpc_tpu/solver/pallas_kernel.py::
// make_pallas_point_stab_solver (its `kernel`, launched by pl.pallas_call):
// per scenario, RK4 rollouts with closed-form A/B, the analytic
// quadratization of the goal/control quadratics, the reverse penalty
// exp(-rf v), the log barrier and the Gaussian obstacle sum, the backward
// Riccati sweep, the first-accept Armijo line search, barrier continuation
// with a stage-level early exit, the true cost and the adjoint KKT residual.
//
// What bounds it on an H100: latency and occupancy on FP32 and SFU work
// (sin/cos, exp, log, division), not bytes. One scenario's schedule is a
// long chain of dependent scalar operations; the inputs are a few hundred
// bytes per scenario and the scratch (303 floats at N=20) stays in L1/L2.
// At the main path's B=4096, one thread per scenario gives 128 warps for
// 132 SMs, so each SM sub-partition holds at most one warp and the
// dependency latency is barely hidden.
//
// What the design does about it: one thread runs one scenario end to end
// in registers, with its own early exits (zero obstacle weight, the live
// obstacle prefix, the converged barrier stage, the first accepted step),
// so no scenario waits on a tile; structure-of-arrays planes keep every
// load coalesced; the paired polynomial sin/cos replaces three libdevice
// sincosf calls per RK4 step. Spreading a scenario over a warp (the
// obstacle sum over lanes) or over the horizon is left for later work.
#include "common.cuh"

namespace mpc {

struct PointStabModel {
  float x0[3];
  float gx, gy, gth, Q0, Q1, Q2, R0, R1, rf, dt, dt6;
  int fast;
  Obstacles obs;

  // x0g: (6, B) px0, py0, th0, gx, gy, gth
  // w:   (8, B) Q0, Q1, Q2, R0, R1, rf, obstacle_weight*gain, 1/ir^2
  __device__ PointStabModel(const float* x0g_, const float* w_, const float* obs_, int n_obs,
                            const SolveArgs& a, int b) {
    const Plane<const float> x0g = plane(x0g_, a.B, b), w = plane(w_, a.B, b);
    x0[0] = x0g[0];
    x0[1] = x0g[1];
    x0[2] = x0g[2];
    gx = x0g[3];
    gy = x0g[4];
    gth = x0g[5];
    Q0 = w[0];
    Q1 = w[1];
    Q2 = w[2];
    R0 = w[3];
    R1 = w[4];
    rf = w[5];
    dt = a.dt;
    dt6 = dt / 6.f;
    fast = a.fast_sincos;
    obs.init(obs_, n_obs, a.B, b, w[6], w[7]);
  }

  // RK4 for f = (v cos th, v sin th, w): k3 == k2, stage angles th, th +
  // dt w / 2, th + dt w.
  __device__ void step(float& px, float& py, float& th, float v, float w) const {
    const float th2 = th + 0.5f * dt * w, th4 = th + dt * w;
    float c0, s0, c2, s2, c4, s4;
    sincos_sel(fast, th, &c0, &s0);
    sincos_sel(fast, th2, &c2, &s2);
    sincos_sel(fast, th4, &c4, &s4);
    const float c = dt6 * (c0 + 4.f * c2 + c4);
    const float s = dt6 * (s0 + 4.f * s2 + s4);
    px = px + v * c;
    py = py + v * s;
    th = th4;
  }

  __device__ Jac jac(float px, float py, float th, float v, float w) const {
    const float th2 = th + 0.5f * dt * w, th4 = th + dt * w;
    float c0, s0, c2, s2, c4, s4;
    sincos_sel(fast, th, &c0, &s0);
    sincos_sel(fast, th2, &c2, &s2);
    sincos_sel(fast, th4, &c4, &s4);
    const float C = dt6 * (c0 + 4.f * c2 + c4);
    const float S = dt6 * (s0 + 4.f * s2 + s4);
    Jac j;
    j.a02 = -v * S;
    j.a12 = v * C;
    j.bc = C;
    j.bsn = S;
    j.b01 = -(v * dt6) * (4.f * s2 * (0.5f * dt) + s4 * dt);
    j.b11 = (v * dt6) * (4.f * c2 * (0.5f * dt) + c4 * dt);
    return j;
  }

  __device__ float stage_cost(int, float px, float py, float th, float v, float w) const {
    const float ex = px - gx, ey = py - gy, eth = th - gth;
    float c = Q0 * ex * ex + Q1 * ey * ey + Q2 * eth * eth;
    c = c + R0 * v * v + R1 * w * w + expf(-rf * v);
    return c + obs.value(px, py);
  }

  __device__ Grad grad(int, float px, float py, float th, float v, float w) const {
    float ogx, ogy, ohxx, ohxy, ohyy;
    obs.terms(px, py, ogx, ogy, ohxx, ohxy, ohyy);
    const float er = expf(-rf * v);
    Grad g;
    g.lx0 = 2.f * Q0 * (px - gx) + ogx;
    g.lx1 = 2.f * Q1 * (py - gy) + ogy;
    g.lx2 = 2.f * Q2 * (th - gth);
    g.lu0 = 2.f * R0 * v - rf * er;
    g.lu1 = 2.f * R1 * w;
    g.lxx00 = 2.f * Q0 + ohxx;
    g.lxx01 = ohxy;
    g.lxx11 = 2.f * Q1 + ohyy;
    g.lxx22 = 2.f * Q2;
    g.luu00 = 2.f * R0 + rf * rf * er;
    g.luu11 = 2.f * R1;
    return g;
  }

  // no terminal cost (reference quirk #5)
  __device__ float terminal_cost(float, float, float) const { return 0.f; }
  __device__ Value terminal_value(float, float, float) const { return Value{}; }
};

__global__ void __launch_bounds__(128)
    point_stab_kernel(const float* x0g, const float* w, const float* obs, int n_obs, SolveArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const PointStabModel m(x0g, w, obs, n_obs, a, b);
  bank_solve(m, a, b);
}

}  // namespace mpc

extern "C" {

// Launch K1 on `stream` (one thread per scenario, `block` threads a block);
// returns the cudaError_t of the launch.
int mpc_point_stab_launch(const float* x0g, const float* w, const float* obs, const float* u0,
                          const float* mu, const int* stage, const int* first, float* U, float* X,
                          float* kff, float* kfb, float* Ubest, float* cost, float* kkt, int* iters,
                          int* lsro, int B, int N, int n_obs, int n_iters, int n_alphas, float dt,
                          float lo_v, float hi_v, float lo_w, float hi_w, float eps_v, float eps_w,
                          float c1, float reg_init, float reg_min, float reg_max, float stage_tol,
                          int fast_sincos, int block, void* stream) {
  const mpc::SolveArgs a = mpc::solve_args(u0, mu, stage, first, U, X, kff, kfb, Ubest, cost, kkt,
                                           iters, lsro, B, N, n_iters, n_alphas, fast_sincos, dt,
                                           lo_v, hi_v, lo_w, hi_w, eps_v, eps_w, c1, reg_init,
                                           reg_min, reg_max, stage_tol);
  const int grid = (B + block - 1) / block;
  mpc::point_stab_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x0g, w, obs,
                                                                              n_obs, a);
  return static_cast<int>(cudaGetLastError());
}

// K1's registers, local memory bytes and resident blocks per SM at `block`
// threads (out[0..2]); returns a cudaError_t.
int mpc_point_stab_info(int block, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mpc::point_stab_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], mpc::point_stab_kernel, block, 0));
}

// Message of a cudaError_t returned by the entry points of both kernels.
const char* mpc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
