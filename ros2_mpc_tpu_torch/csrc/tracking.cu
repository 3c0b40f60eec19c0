// K2: whole-solver bank kernel for unicycle trajectory tracking.
//
// Replaces the TPU kernel ros2_mpc_tpu/solver/pallas_kernel.py::
// make_pallas_tracking_solver (its `kernel`, launched by pl.pallas_call).
// Same schedule as K1 (common.cuh bank_solve) for the tracking formulation:
// an Euler transition, per-stage x_ref/u_ref windows (stage k against
// x_ref[k], reference quirk #4), the Gaussian obstacle sum over stages
// 0..N, an optional terminal pose quadratic against x_ref[N-1], and in
// corrected mode (wrap_yaw) the yaw error wrapped to (-pi, pi] in the cost,
// its gradient and the adjoint seed.
//
// What bounds it on an H100 is what bounds K1 (point_stab.cu): dependent
// FP32 and SFU latency at one thread per scenario, with 128 warps at the
// main path's B=4096. The Euler step needs one sin/cos per step instead of
// RK4's three; the references add 5 coalesced loads per stage. The design
// is K1's: one thread per scenario, per-scenario exits, structure-of-arrays
// planes.
#include "common.cuh"

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

__global__ void __launch_bounds__(128)
    tracking_kernel(const float* x0, const float* xref, const float* uref, const float* w,
                    const float* obs, int n_obs, int wrap_yaw, SolveArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const TrackingModel m(x0, xref, uref, w, obs, n_obs, wrap_yaw, a, b);
  bank_solve(m, a, b);
}

}  // namespace mpc

extern "C" {

// Launch K2 on `stream`; returns the cudaError_t of the launch.
int mpc_tracking_launch(const float* x0, const float* xref, const float* uref, const float* w,
                        const float* obs, const float* u0, const float* mu, const int* stage,
                        const int* first, float* U, float* X, float* kff, float* kfb, float* Ubest,
                        float* cost, float* kkt, int* iters, int* lsro, int B, int N, int n_obs,
                        int n_iters, int n_alphas, float dt, float lo_v, float hi_v, float lo_w,
                        float hi_w, float eps_v, float eps_w, float c1, float reg_init,
                        float reg_min, float reg_max, float stage_tol, int fast_sincos,
                        int wrap_yaw, int block, void* stream) {
  const mpc::SolveArgs a = mpc::solve_args(u0, mu, stage, first, U, X, kff, kfb, Ubest, cost, kkt,
                                           iters, lsro, B, N, n_iters, n_alphas, fast_sincos, dt,
                                           lo_v, hi_v, lo_w, hi_w, eps_v, eps_w, c1, reg_init,
                                           reg_min, reg_max, stage_tol);
  const int grid = (B + block - 1) / block;
  mpc::tracking_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, xref, uref, w, obs, n_obs, wrap_yaw, a);
  return static_cast<int>(cudaGetLastError());
}

// K2's registers, local memory bytes and resident blocks per SM at `block`
// threads (out[0..2]); returns a cudaError_t.
int mpc_tracking_info(int block, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mpc::tracking_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], mpc::tracking_kernel, block, 0));
}

}  // extern "C"
