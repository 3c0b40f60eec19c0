// K2: whole-solver bank kernel for unicycle trajectory tracking.
//
// Replaces the TPU kernel ros2_mpc_tpu/solver/pallas_kernel.py::
// make_pallas_tracking_solver (its `kernel`, launched by pl.pallas_call):
// K1's schedule (group_solve.cuh bank_solve_group) for the tracking
// formulation: an Euler transition, per-stage x_ref/u_ref windows (stage k
// against x_ref[k], reference quirk #4), the Gaussian obstacle sum over
// stages 0..N, an optional terminal pose quadratic against x_ref[N-1], and
// in corrected mode (wrap_yaw) the yaw error wrapped to (-pi, pi] in the
// cost, its gradient and the adjoint seed.
//
// What bounds it on an H100 is what bounds K1 (point_stab.cu): a long chain
// of dependent FP32 and SFU operations per scenario on a few hundred bytes
// of input. The Euler step needs one sin/cos per step instead of RK4's three, and
// the reference windows add 5 loads per stage.
//
// What the design does about it is K1's: one scenario on a group of G
// lanes, the per-stage derivatives one stage per lane and the line-search
// candidates one step size per lane, the iterate, gains and candidates in
// shared memory sized at launch from N and n_alphas. The derivative phase
// reads the reference windows one stage per lane, the candidates the same
// stage on every lane of a group, so each group first copies its
// scenario's windows (5N floats) into shared memory ahead of the schedule's
// scratch: faster than reading them from device memory at 11 of the 12
// swept geometries (PERF.md). The terminal quadratic is added after the
// stage terms, and the adjoint seed is terminal_value at X[N], as in the
// plain version, so K2 stays bit-equal to it. The lanes per scenario and
// the scenarios per block are compile-time constants fixed by measurement
// (PERF.md): geometry_sweep.py builds its own libraries with other values
// through -DMPC_K2_GROUP and -DMPC_K2_SCENARIOS_PER_BLOCK.
#include "group_solve.cuh"

namespace mpc {

struct TrackingModel {
  float x0[3];
  float Q0, Q1, Q2, R0, R1, rf, TW0, TW1, TW2, dt;
  int fast, wrap, N;
  Plane<const float> xref, uref;
  Obstacles obs;

  // x0: (3, B); x_ref: (N, 3, B); u_ref: (N, 2, B)
  // w: (11, B) Q0, Q1, Q2, R0, R1, rf, obstacle_weight*gain, 1/ir^2, TW0-2
  __device__ TrackingModel(const float* x0_, const float* xref_, const float* uref_,
                           const float* w_, const float* obs_, int n_obs, int wrap_yaw,
                           const SolveArgs& a, int b) {
    const Plane<const float> xi = plane(x0_, a.B, b), w = plane(w_, a.B, b);
    x0[0] = xi[0];
    x0[1] = xi[1];
    x0[2] = xi[2];
    xref = plane(xref_, a.B, b);
    uref = plane(uref_, a.B, b);
    Q0 = w[0];
    Q1 = w[1];
    Q2 = w[2];
    R0 = w[3];
    R1 = w[4];
    rf = w[5];
    TW0 = w[8];
    TW1 = w[9];
    TW2 = w[10];
    dt = a.dt;
    fast = a.fast_sincos;
    wrap = wrap_yaw;
    obs.init(obs_, n_obs, a.B, b, w[6], w[7]);
    N = a.N;
  }

  // corrected-mode yaw error wrap: gradient 1 almost everywhere
  __device__ float wyaw(float e) const {
    return wrap ? e - 0x1.921fb6p+2f * rintf(e * 0x1.45f306p-3f) : e;
  }

  __device__ void step(float& px, float& py, float& th, float v, float w) const {
    float c, s;
    sincos_sel(fast, th, &c, &s);
    px = px + dt * v * c;
    py = py + dt * v * s;
    th = th + dt * w;
  }

  __device__ Jac jac(float, float, float th, float v, float) const {
    float c, s;
    sincos_sel(fast, th, &c, &s);
    Jac j;
    j.a02 = -dt * v * s;
    j.a12 = dt * v * c;
    j.bc = dt * c;
    j.bsn = dt * s;
    j.b01 = 0.f;
    j.b11 = 0.f;
    return j;
  }

  __device__ float stage_cost(int k, float px, float py, float th, float v, float w) const {
    const float ex = px - xref[3 * k], ey = py - xref[3 * k + 1];
    const float eth = wyaw(th - xref[3 * k + 2]);
    const float ev = v - uref[2 * k], ew = w - uref[2 * k + 1];
    float c = Q0 * ex * ex + Q1 * ey * ey + Q2 * eth * eth;
    c = c + R0 * ev * ev + R1 * ew * ew + expf(-rf * v);
    return c + obs.value(px, py);
  }

  __device__ Grad grad(int k, float px, float py, float th, float v, float w) const {
    float ogx, ogy, ohxx, ohxy, ohyy;
    obs.terms(px, py, ogx, ogy, ohxx, ohxy, ohyy);
    const float ex = px - xref[3 * k], ey = py - xref[3 * k + 1];
    const float eth = wyaw(th - xref[3 * k + 2]);
    const float ev = v - uref[2 * k], ew = w - uref[2 * k + 1];
    const float er = expf(-rf * v);
    Grad g;
    g.lx0 = 2.f * Q0 * ex + ogx;
    g.lx1 = 2.f * Q1 * ey + ogy;
    g.lx2 = 2.f * Q2 * eth;
    g.lu0 = 2.f * R0 * ev - rf * er;
    g.lu1 = 2.f * R1 * ew;
    g.lxx00 = 2.f * Q0 + ohxx;
    g.lxx01 = ohxy;
    g.lxx11 = 2.f * Q1 + ohyy;
    g.lxx22 = 2.f * Q2;
    g.luu00 = 2.f * R0 + rf * rf * er;
    g.luu11 = 2.f * R1;
    return g;
  }

  // stage-N obstacle term + the optional terminal pose quadratic
  __device__ float terminal_cost(float px, float py, float th) const {
    const int r = 3 * (N - 1);
    const float ex = px - xref[r], ey = py - xref[r + 1], eth = wyaw(th - xref[r + 2]);
    return obs.value(px, py) + (TW0 * ex * ex + TW1 * ey * ey + TW2 * eth * eth);
  }

  __device__ Value terminal_value(float px, float py, float th) const {
    float ogx, ogy, ohxx, ohxy, ohyy;
    obs.terms(px, py, ogx, ogy, ohxx, ohxy, ohyy);
    const int r = 3 * (N - 1);
    const float ex = px - xref[r], ey = py - xref[r + 1], eth = wyaw(th - xref[r + 2]);
    Value V;
    V.vx0 = ogx + 2.f * TW0 * ex;
    V.vx1 = ogy + 2.f * TW1 * ey;
    V.vx2 = 2.f * TW2 * eth;
    V.v00 = ohxx + 2.f * TW0;
    V.v01 = ohxy;
    V.v02 = 0.f;
    V.v11 = ohyy + 2.f * TW1;
    V.v12 = 0.f;
    V.v22 = 2.f * TW2;
    return V;
  }
};

#ifndef MPC_K2_GROUP
#define MPC_K2_GROUP 8
#endif
#ifndef MPC_K2_SCENARIOS_PER_BLOCK
#define MPC_K2_SCENARIOS_PER_BLOCK 16
#endif
constexpr int kGroup = MPC_K2_GROUP;  // lanes a scenario
constexpr int kScenariosPerBlock = MPC_K2_SCENARIOS_PER_BLOCK;
constexpr int kWindowFloats = 5;  // floats a stage of the reference windows

// At most 256 threads a block and one wave of the 4096-scenario bank, as K1.
__global__ void __launch_bounds__(256, kGroup / 8)
    tracking_kernel(const float* x0, const float* xref, const float* uref, const float* w,
                    const float* obs, int n_obs, int wrap_yaw, SolveArgs a, int scenarios_per_block,
                    int scratch) {
  extern __shared__ float smem[];
  const int gi = threadIdx.x / kGroup;
  const int b = blockIdx.x * scenarios_per_block + gi;
  if (b >= a.B) return;  // the whole group leaves together
  float* s = smem + gi * scratch;
  TrackingModel m(x0, xref, uref, w, obs, n_obs, wrap_yaw, a, b);
  // the windows go ahead of the schedule's scratch
  const LaneGroup<kGroup> grp;
  for (int i = grp.lane; i < 3 * a.N; i += kGroup) s[i] = m.xref[i];
  for (int i = grp.lane; i < 2 * a.N; i += kGroup) s[3 * a.N + i] = m.uref[i];
  grp.sync();
  m.xref = Plane<const float>{s, 1};
  m.uref = Plane<const float>{s + 3 * a.N, 1};
  bank_solve_group<TrackingModel, kGroup>(m, a, b, s + kWindowFloats * a.N);
}

}  // namespace mpc

extern "C" {

// Launch K2 on `stream` (one scenario on MPC_K2_GROUP lanes, shared memory
// sized from N and n_alphas); returns the cudaError_t of the launch, or
// cudaErrorInvalidValue where one scenario does not fit in a block.
int mpc_tracking_launch(const float* x0, const float* xref, const float* uref, const float* w,
                        const float* obs, const float* u0, const float* mu, const int* stage,
                        const int* first, float* U, float* X, float* cost, float* kkt, int* iters,
                        int* lsro, int B, int N, int n_obs, int n_iters, int n_alphas, float dt,
                        float lo_v, float hi_v, float lo_w, float hi_w, float eps_v, float eps_w,
                        float c1, float reg_init, float reg_min, float reg_max, float stage_tol,
                        int fast_sincos, int wrap_yaw, void* stream) {
  const mpc::Geometry g =
      mpc::geometry<mpc::kGroup, mpc::kScenariosPerBlock, mpc::kWindowFloats>(B, N, n_alphas);
  if (g.spb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = mpc::allow_smem(mpc::tracking_kernel, g.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const mpc::SolveArgs a = mpc::solve_args(u0, mu, stage, first, U, X, cost, kkt, iters, lsro, B,
                                           N, n_iters, n_alphas, fast_sincos, dt, lo_v, hi_v,
                                           lo_w, hi_w, eps_v, eps_w, c1, reg_init, reg_min,
                                           reg_max, stage_tol);
  const int grid = (B + g.spb - 1) / g.spb;
  mpc::tracking_kernel<<<grid, g.spb * mpc::kGroup, g.smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(x0, xref, uref, w, obs, n_obs,
                                                              wrap_yaw, a, g.spb, g.scratch);
  return static_cast<int>(cudaGetLastError());
}

// K2's launch for B scenarios at (N, n_alphas) and what the card makes of
// it (group_solve.cuh group_info); returns a cudaError_t.
int mpc_tracking_info(int B, int N, int n_alphas, int* out) {
  return static_cast<int>(mpc::group_info<mpc::kGroup, mpc::kScenariosPerBlock, mpc::kWindowFloats>(
      mpc::tracking_kernel, B, N, n_alphas, out));
}

}  // extern "C"
