// Shared device code of the whole-solver bank kernels (point_stab.cu, tracking.cu):
// the numeric helpers, the obstacle sums, the Riccati step and the launch
// arguments. The schedule itself, the interior-point iLQR of
// ros2_mpc_tpu/solver/pallas_kernel.py (barrier stages, Riccati sweep,
// first-accept Armijo line search, stage-level early exit, true cost and
// adjoint KKT residual) on a group of lanes per scenario, is
// group_solve.cuh's bank_solve_group. The problem-specific parts
// (transition, its Jacobian, the stage and terminal costs and their
// derivatives) come from each kernel's Model struct.
//
// Layout: structure of arrays with the scenario index as the minor axis,
// element i of scenario b at p[i * B + b]. Inputs and outputs are allocated
// by the Python wrapper, the scratch lives in shared memory; the kernels
// allocate nothing.
//
// Numerics follow jax.numpy where it matters for parity:
//  * clip, max and min keep NaN (jnp.clip/maximum/minimum do; fminf/fmaxf
//    would clip a NaN to a bound and could get a bad line-search step
//    accepted);
//  * the yaw wrap rounds half to even (rintf, as jnp.round);
//  * step sizes are exact powers of two (ldexpf), as make_solver's 0.5**a;
//    the TPU kernel formed exp(-ln2 * a), which can be an ulp off;
//  * no --use_fast_math: expf/logf/division stay IEEE and denormals are
//    kept (the barrier terms mu/s^2 run with mu down to 1e-8);
//  * built with -fmad=false (_build.py) and written in the plain versions'
//    order of operations, so kernel and plain version agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mpc {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // NaN compares false: passes through
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;  // NaN if either is NaN
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// Paired cos/sin from one 2*pi reduction and the odd/even polynomials of
// pallas_kernel.py::_fast_sincos (same float32 coefficients; max abs error
// ~3.3e-6 for |x| <= 60 rad). fast == 0 takes the libdevice sincosf.
__device__ __forceinline__ void sincos_sel(int fast, float x, float* c, float* s) {
  if (!fast) {
    sincosf(x, s, c);
    return;
  }
  const float r = x - 0x1.921fb6p+2f * floorf(x * 0x1.45f306p-3f + 0.5f);  // x - 2pi*round
  const float t = r * 0x1.45f306p-2f;                                      // r / pi
  const float t2 = t * t;
  float ps = 0x1.9c0dc2p-12f;  // sin(pi t) = t * P(t^2)
  ps = ps * t2 - 0x1.dc4568p-8f;
  ps = ps * t2 + 0x1.5029fcp-4f;
  ps = ps * t2 - 0x1.32cf02p-1f;
  ps = ps * t2 + 0x1.466b96p+1f;
  ps = ps * t2 - 0x1.4abbccp+2f;
  ps = ps * t2 + 0x1.921fb6p+1f;
  float pc = -0x1.760144p-14f;  // cos(pi t) = Q(t^2)
  pc = pc * t2 + 0x1.f39f96p-10f;
  pc = pc * t2 - 0x1.a6821ap-6f;
  pc = pc * t2 + 0x1.e1f092p-3f;
  pc = pc * t2 - 0x1.55d3a6p+0f;
  pc = pc * t2 + 0x1.03c1f0p+2f;
  pc = pc * t2 - 0x1.3bd3ccp+2f;
  pc = pc * t2 + 0x1.000000p+0f;
  *c = pc;
  *s = ps * t;
}

// One plane of a structure-of-arrays tensor, already offset to scenario b.
template <class T>
struct Plane {
  T* p;
  int B;
  __device__ __forceinline__ T& operator[](int i) const { return p[(size_t)i * B]; }
};

template <class T>
__device__ __forceinline__ Plane<T> plane(T* base, int B, int b) {
  return Plane<T>{base + b, B};
}

// ----------------------------------------------------------- obstacle sums

// ow * sum_j exp(-r_j^2 * inv_ir2) over one scenario's padded obstacle
// vectors (2, n_obs, B). Exits are per scenario: a zero weight skips the
// sum, and only the live prefix is walked (points beyond +-90 m on both
// axes are the 100 m sentinels; their Gaussian term underflows to exactly
// 0.0f, so skipping them is exact).
struct Obstacles {
  Plane<const float> ox, oy;
  int n_live;
  float ow, inv_ir2;

  __device__ void init(const float* obs, int n_obs, int B, int b, float ow_, float inv_ir2_) {
    ox = plane(obs, B, b);
    oy = plane(obs + (size_t)n_obs * B, B, b);
    ow = ow_;
    inv_ir2 = inv_ir2_;
    n_live = 0;
    if (fabsf(ow) > 0.f) {
      for (int j = 0; j < n_obs; ++j) {
        if (fabsf(ox[j]) < 90.f || fabsf(oy[j]) < 90.f) n_live = j + 1;
      }
    }
  }

  __device__ float value(float px, float py) const {
    float acc = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float dx = px - ox[j], dy = py - oy[j];
      acc += ow * expf(-(dx * dx + dy * dy) * inv_ir2);
    }
    return acc;
  }

  // gradient and Hessian of value() in (px, py)
  __device__ void terms(float px, float py, float& gx, float& gy, float& hxx, float& hxy,
                        float& hyy) const {
    gx = gy = hxx = hxy = hyy = 0.f;
    const float i2 = inv_ir2;
    for (int j = 0; j < n_live; ++j) {
      const float dx = px - ox[j], dy = py - oy[j];
      const float e = ow * expf(-(dx * dx + dy * dy) * i2);
      gx += -2.f * i2 * dx * e;
      gy += -2.f * i2 * dy * e;
      hxx += e * (4.f * i2 * i2 * dx * dx - 2.f * i2);
      hxy += e * 4.f * i2 * i2 * dx * dy;
      hyy += e * (4.f * i2 * i2 * dy * dy - 2.f * i2);
    }
  }
};

// ------------------------------------------------------------- the solver

// A = [[1,0,a02],[0,1,a12],[0,0,1]],  B = [[bc,b01],[bsn,b11],[0,dt]]
struct Jac {
  float a02, a12, bc, bsn, b01, b11;
};

// stage-cost derivatives without the barrier (l_ux == 0: the cost is
// separable in x and u)
struct Grad {
  float lx0, lx1, lx2, lu0, lu1, lxx00, lxx01, lxx11, lxx22, luu00, luu11;
};

// value-function gradient and (symmetric) Hessian
struct Value {
  float vx0, vx1, vx2, v00, v01, v02, v11, v12, v22;
};

struct SolveArgs {
  const float* u0;     // (N, 2, B) warm start
  const float* mu;     // (n_iters,) barrier schedule
  const int* stage;    // (n_iters,) barrier stage of each iteration
  const int* first;    // (n_iters,) 1 on a stage's first iteration
  float* U;            // (N, 2, B)   out: controls
  float* X;            // (N+1, 3, B) out: their rollout
  float* cost;         // (B,) true cost
  float* kkt;          // (B,) projected-gradient KKT residual
  int* iters;          // (B,) executed iterations
  int* lsro;           // (B,) executed line-search candidate rollouts
  int B, N, n_iters, n_alphas, fast_sincos;
  float dt, lo_v, hi_v, lo_w, hi_w, eps_v, eps_w, c1, reg_init, reg_min, reg_max, stage_tol;
};

// Field by field, so that a reordering of SolveArgs cannot shift arguments.
inline SolveArgs solve_args(const float* u0, const float* mu, const int* stage, const int* first,
                            float* U, float* X, float* cost, float* kkt, int* iters,
                            int* lsro, int B, int N, int n_iters,
                            int n_alphas, int fast_sincos, float dt, float lo_v, float hi_v,
                            float lo_w, float hi_w, float eps_v, float eps_w, float c1,
                            float reg_init, float reg_min, float reg_max, float stage_tol) {
  SolveArgs a;
  a.u0 = u0;
  a.mu = mu;
  a.stage = stage;
  a.first = first;
  a.U = U;
  a.X = X;
  a.cost = cost;
  a.kkt = kkt;
  a.iters = iters;
  a.lsro = lsro;
  a.B = B;
  a.N = N;
  a.n_iters = n_iters;
  a.n_alphas = n_alphas;
  a.fast_sincos = fast_sincos;
  a.dt = dt;
  a.lo_v = lo_v;
  a.hi_v = hi_v;
  a.lo_w = lo_w;
  a.hi_w = hi_w;
  a.eps_v = eps_v;
  a.eps_w = eps_w;
  a.c1 = c1;
  a.reg_init = reg_init;
  a.reg_min = reg_min;
  a.reg_max = reg_max;
  a.stage_tol = stage_tol;
  return a;
}

__device__ __forceinline__ float barrier(const SolveArgs& a, float v, float w) {
  return logf(v - a.lo_v) + logf(a.hi_v - v) + logf(w - a.lo_w) + logf(a.hi_w - w);
}

// One backward Riccati step at stage k (l_ux == 0, Levenberg reg on Quu,
// closed-form 2x2 solve with heavy diagonal loading when Quu is not PD).
// Updates the value function V in place and returns the gains.
__device__ __forceinline__ void riccati_step(Value& V, const Jac& j, const Grad& g, float reg,
                                             float dt, float kf[2], float K[2][3], float& dV1,
                                             float& dV2) {
  const float qx0 = g.lx0 + V.vx0;
  const float qx1 = g.lx1 + V.vx1;
  const float qx2 = g.lx2 + j.a02 * V.vx0 + j.a12 * V.vx1 + V.vx2;
  const float qu0 = g.lu0 + j.bc * V.vx0 + j.bsn * V.vx1;
  const float qu1 = g.lu1 + j.b01 * V.vx0 + j.b11 * V.vx1 + dt * V.vx2;

  // Vxx A; A's columns are e0, e1, (a02, a12, 1)
  const float va02 = V.v00 * j.a02 + V.v01 * j.a12 + V.v02;
  const float va12 = V.v01 * j.a02 + V.v11 * j.a12 + V.v12;
  const float va22 = V.v02 * j.a02 + V.v12 * j.a12 + V.v22;
  const float q00 = g.lxx00 + V.v00;
  const float q01 = g.lxx01 + V.v01;
  const float q02 = va02;
  const float q11 = g.lxx11 + V.v11;
  const float q12 = va12;
  const float q22 = g.lxx22 + j.a02 * va02 + j.a12 * va12 + va22;

  // Vxx B; B's columns are (bc, bsn, 0) and (b01, b11, dt)
  const float vb00 = V.v00 * j.bc + V.v01 * j.bsn;
  const float vb10 = V.v01 * j.bc + V.v11 * j.bsn;
  const float vb01 = V.v00 * j.b01 + V.v01 * j.b11 + V.v02 * dt;
  const float vb11 = V.v01 * j.b01 + V.v11 * j.b11 + V.v12 * dt;
  const float vb21 = V.v02 * j.b01 + V.v12 * j.b11 + V.v22 * dt;
  float quu00 = g.luu00 + j.bc * vb00 + j.bsn * vb10 + reg;
  const float quu01 = j.bc * vb01 + j.bsn * vb11;
  float quu11 = g.luu11 + j.b01 * vb01 + j.b11 * vb11 + dt * vb21 + reg;
  // Qux = B^T Vxx A
  const float qux00 = j.bc * V.v00 + j.bsn * V.v01;
  const float qux01 = j.bc * V.v01 + j.bsn * V.v11;
  const float qux02 = j.bc * va02 + j.bsn * va12;
  const float qux10 = j.b01 * V.v00 + j.b11 * V.v01 + dt * V.v02;
  const float qux11 = j.b01 * V.v01 + j.b11 * V.v11 + dt * V.v12;
  const float qux12 = j.b01 * va02 + j.b11 * va12 + dt * va22;

  float det = quu00 * quu11 - quu01 * quu01;
  if (det <= 1e-12f || min_nan(quu00, quu11) <= 0.f) {
    quu00 += 1e3f;
    quu11 += 1e3f;
    det = quu00 * quu11 - quu01 * quu01;
  }
  const float inv_det = 1.f / det;
  // x = Quu^{-1} r
#define MPC_SOLVE2(r0, r1, x0, x1)                 \
  x0 = (quu11 * (r0) - quu01 * (r1)) * inv_det; \
  x1 = (quu00 * (r1) - quu01 * (r0)) * inv_det;
  MPC_SOLVE2(-qu0, -qu1, kf[0], kf[1])
  MPC_SOLVE2(-qux00, -qux10, K[0][0], K[1][0])
  MPC_SOLVE2(-qux01, -qux11, K[0][1], K[1][1])
  MPC_SOLVE2(-qux02, -qux12, K[0][2], K[1][2])
#undef MPC_SOLVE2
  const float kf0 = kf[0], kf1 = kf[1];
  const float K00 = K[0][0], K01 = K[0][1], K02 = K[0][2];
  const float K10 = K[1][0], K11 = K[1][1], K12 = K[1][2];

  // Vx' = Qx + K^T Quu kff + K^T Qu + Qux^T kff
  const float qk0 = quu00 * kf0 + quu01 * kf1;
  const float qk1 = quu01 * kf0 + quu11 * kf1;
  V.vx0 = qx0 + K00 * qk0 + K10 * qk1 + K00 * qu0 + K10 * qu1 + qux00 * kf0 + qux10 * kf1;
  V.vx1 = qx1 + K01 * qk0 + K11 * qk1 + K01 * qu0 + K11 * qu1 + qux01 * kf0 + qux11 * kf1;
  V.vx2 = qx2 + K02 * qk0 + K12 * qk1 + K02 * qu0 + K12 * qu1 + qux02 * kf0 + qux12 * kf1;
  // Vxx' = Qxx + K^T Quu K + K^T Qux + Qux^T K (symmetric by construction)
  const float qkK0 = quu00 * K00 + quu01 * K10;
  const float qkK1 = quu01 * K00 + quu11 * K10;
  const float qkK0b = quu00 * K01 + quu01 * K11;
  const float qkK1b = quu01 * K01 + quu11 * K11;
  const float qkK0c = quu00 * K02 + quu01 * K12;
  const float qkK1c = quu01 * K02 + quu11 * K12;
  V.v00 = q00 + K00 * qkK0 + K10 * qkK1 + 2.f * (K00 * qux00 + K10 * qux10);
  V.v01 = q01 + K00 * qkK0b + K10 * qkK1b + (K00 * qux01 + K10 * qux11) + (K01 * qux00 + K11 * qux10);
  V.v02 = q02 + K00 * qkK0c + K10 * qkK1c + (K00 * qux02 + K10 * qux12) + (K02 * qux00 + K12 * qux10);
  V.v11 = q11 + K01 * qkK0b + K11 * qkK1b + 2.f * (K01 * qux01 + K11 * qux11);
  V.v12 = q12 + K01 * qkK0c + K11 * qkK1c + (K01 * qux02 + K11 * qux12) + (K02 * qux01 + K12 * qux11);
  V.v22 = q22 + K02 * qkK0c + K12 * qkK1c + 2.f * (K02 * qux02 + K12 * qux12);

  dV1 += kf0 * qu0 + kf1 * qu1;
  dV2 += 0.5f * (kf0 * qk0 + kf1 * qk1);
}

}  // namespace mpc
