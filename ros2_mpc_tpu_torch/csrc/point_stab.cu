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
// bytes per scenario. With one thread per scenario, the main path's
// B=4096 gave 128 warps for 132 SMs, and each iteration's chain held the
// rollout, the derivatives of every stage and ~2-3 candidate rollouts of
// the line search.
//
// What the design does about it: one scenario is a group of G lanes
// (group_solve.cuh bank_solve_group). The per-stage derivatives and cost
// terms run one stage per lane, the line-search candidates one step size
// per lane, so an iteration's chain is the Riccati sweep and one candidate
// rollout; the iterate, the gains and the candidates live in shared memory,
// sized at launch from N and n_alphas. 4096 scenarios are 4096 * G / 32
// warps. Each scenario keeps its own early exits and its plain version's order
// of operations, so K1 stays bit-equal to it. The lanes per
// scenario and the scenarios per block are compile-time constants fixed by
// measurement (PERF.md): geometry_sweep.py builds its own libraries with other
// values through -DMPC_K1_GROUP and -DMPC_K1_SCENARIOS_PER_BLOCK.
#include "group_solve.cuh"

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

#ifndef MPC_K1_GROUP
#define MPC_K1_GROUP 8
#endif
#ifndef MPC_K1_SCENARIOS_PER_BLOCK
#define MPC_K1_SCENARIOS_PER_BLOCK 16
#endif
constexpr int kGroup = MPC_K1_GROUP;  // lanes a scenario
constexpr int kScenariosPerBlock = MPC_K1_SCENARIOS_PER_BLOCK;

// At most 256 threads a block, and enough resident blocks per SM for one
// wave of the 4096-scenario bank (4096 * G / 32 warps on 132 SMs): this caps
// the registers at 255 (G=8), 128 (G=16) or 64 (G=32) a thread.
__global__ void __launch_bounds__(256, kGroup / 8)
    point_stab_kernel(const float* x0g, const float* w, const float* obs, int n_obs, SolveArgs a,
                      int scenarios_per_block, int scratch) {
  extern __shared__ float smem[];
  const int gi = threadIdx.x / kGroup;
  const int b = blockIdx.x * scenarios_per_block + gi;
  if (b >= a.B) return;  // the whole group leaves together
  const PointStabModel m(x0g, w, obs, n_obs, a, b);
  bank_solve_group<PointStabModel, kGroup>(m, a, b, smem + gi * scratch);
}

}  // namespace mpc

extern "C" {

// Launch K1 on `stream` (one scenario on MPC_K1_GROUP lanes, shared memory
// sized from N and n_alphas); returns the cudaError_t of the launch, or
// cudaErrorInvalidValue where one scenario does not fit in a block.
int mpc_point_stab_launch(const float* x0g, const float* w, const float* obs, const float* u0,
                          const float* mu, const int* stage, const int* first, float* U, float* X,
                          float* cost, float* kkt, int* iters, int* lsro, int B, int N, int n_obs,
                          int n_iters, int n_alphas, float dt, float lo_v, float hi_v, float lo_w,
                          float hi_w, float eps_v, float eps_w, float c1, float reg_init,
                          float reg_min, float reg_max, float stage_tol, int fast_sincos,
                          void* stream) {
  const mpc::Geometry g = mpc::geometry<mpc::kGroup, mpc::kScenariosPerBlock>(B, N, n_alphas);
  if (g.spb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = mpc::allow_smem(mpc::point_stab_kernel, g.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const mpc::SolveArgs a = mpc::solve_args(u0, mu, stage, first, U, X, cost, kkt, iters, lsro, B,
                                           N, n_iters, n_alphas, fast_sincos, dt, lo_v, hi_v,
                                           lo_w, hi_w, eps_v, eps_w, c1, reg_init, reg_min,
                                           reg_max, stage_tol);
  const int grid = (B + g.spb - 1) / g.spb;
  mpc::point_stab_kernel<<<grid, g.spb * mpc::kGroup, g.smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(x0g, w, obs, n_obs, a, g.spb,
                                                                g.scratch);
  return static_cast<int>(cudaGetLastError());
}

// K1's launch for B scenarios at (N, n_alphas) and what the card makes of
// it (group_solve.cuh group_info); returns a cudaError_t.
int mpc_point_stab_info(int B, int N, int n_alphas, int* out) {
  return static_cast<int>(mpc::group_info<mpc::kGroup, mpc::kScenariosPerBlock>(
      mpc::point_stab_kernel, B, N, n_alphas, out));
}

// Message of a cudaError_t returned by the entry points of both kernels.
const char* mpc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
