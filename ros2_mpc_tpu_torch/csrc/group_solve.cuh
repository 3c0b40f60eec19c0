// Lane-group schedule of the whole-solver bank kernels (K1 point_stab.cu,
// K2 tracking.cu): one scenario on G lanes of a warp (G = 8, 16 or 32), its
// iterate and scratch in shared memory.
//
// Every scenario's arithmetic is that of the plain versions
// (solver/cuda_kernel.py _bank_plain), in the same order of operations, so
// the result is bit-equal to them. What moves across lanes is the work that
// has no dependency along the horizon:
//
//  * the per-stage terms of the iterate's barrier cost and its derivatives
//    (Model::jac, Model::grad and the four barrier corrections), one stage
//    per lane; the cost is then summed in k order from 0.f, as the plain
//    rollout's `J = J + ...` does, never as a tree, and the terminal cost
//    is added last;
//  * the line search: lane a rolls out the candidate alpha = 2^-(r*G + a)
//    in round r. Each candidate depends only on U, X, kff, kfb and its own
//    alpha, never on a rejected one, so the lowest passing index is what
//    the first-accept search accepts. Rounds run while no candidate passed.
//
// The Riccati sweep and the adjoint KKT sweep stay sequential in k: every
// lane of the group runs them on the same shared records (a broadcast
// read), so no value is shuffled; both start from Model::terminal_value at
// X[N]. The accepted candidate's states become the next iterate's rollout
// (the same transitions on the same controls), so the iterate is rolled out
// once, before the first iteration. The winner's controls and states come
// from its lane's slot in shared memory.
//
// Counters keep the first-accept meaning: iters counts executed iterations,
// lsro the first-accept candidates (the winner's index + 1, or n_alphas if
// none passes), whatever the lanes ran speculatively.
//
// A Model provides, on one scenario: x0[3]; step(px, py, th, v, w) (in
// place); jac(...) -> Jac; stage_cost(k, ...) and grad(k, ...) without the
// barrier; terminal_cost(px, py, th) and terminal_value(px, py, th) -> Value.
//
// Shared memory of one scenario (floats; group_scratch_floats):
//   X (N+1)*3 | U 2N | kff 2N | kfb 6N | stage terms N | work
// where `work` holds the per-stage records (17 floats a stage) while the
// Riccati and adjoint sweeps read them, and the candidates' controls and
// states (5N floats for each of min(G, n_alphas) lanes) during the line
// search. The stride is odd, so the groups of a warp
// reading the same element of their own scenarios fall in different banks.
#pragma once

#include "common.cuh"

namespace mpc {

// floats of one scenario's scratch: `extra` floats the kernel keeps ahead
// of the schedule's (cuda_kernel.group_scratch_floats mirrors it)
__host__ __device__ inline int group_scratch_floats(int N, int n_alphas, int G, int extra) {
  const int slots = n_alphas < G ? n_alphas : G;
  const int recs = 17 * N, cands = 5 * N * slots;
  return (extra + 3 * (N + 1) + 11 * N + (recs > cands ? recs : cands)) | 1;
}

// the most dynamic shared memory a block may have on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;

// A lane-group kernel's launch for B scenarios at (N, n_alphas), G lanes a
// scenario, at most SPB scenarios a block and PerStage floats a stage of the
// kernel's own ahead of each scenario's scratch: fewer scenarios share a
// block where B or the shared-memory budget asks for it
// (cuda_kernel.group_geometry mirrors it).
struct Geometry {
  int scratch;     // floats of one scenario's scratch
  int spb;         // scenarios a block, 0 where one scenario does not fit
  int smem_bytes;  // dynamic shared memory a block
};

template <int G, int SPB, int PerStage = 0>
inline Geometry geometry(int B, int N, int n_alphas) {
  static_assert(SPB >= 1 && G * SPB <= 256, "a lane-group kernel's blocks hold at most 256 threads");
  Geometry g;
  g.scratch = group_scratch_floats(N, n_alphas, G, PerStage * N);
  const int fit = kMaxSmemBytes / (g.scratch * static_cast<int>(sizeof(float)));
  g.spb = SPB < B ? SPB : B;
  g.spb = g.spb < fit ? g.spb : fit;
  g.smem_bytes = g.spb * g.scratch * static_cast<int>(sizeof(float));
  return g;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// A lane-group kernel's launch for B scenarios at (N, n_alphas) and what the
// card makes of it, in out[0..5]: lanes a scenario, scenarios a block,
// dynamic shared memory bytes a block, registers a thread, local memory
// bytes a thread, resident blocks per SM. Returns a cudaError_t.
template <int G, int SPB, int PerStage = 0, class Kernel>
inline cudaError_t group_info(Kernel kernel, int B, int N, int n_alphas, int* out) {
  const Geometry g = geometry<G, SPB, PerStage>(B, N, n_alphas);
  if (g.spb < 1) return cudaErrorInvalidValue;
  out[0] = G;
  out[1] = g.spb;
  out[2] = g.smem_bytes;
  cudaError_t err = allow_smem(kernel, g.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, g.spb * G, g.smem_bytes);
}

// one stage's derivatives: the Jacobian and the stage-cost derivatives
struct StageRec {
  Jac j;
  Grad g;
};
static_assert(sizeof(StageRec) == 17 * sizeof(float), "StageRec is 17 packed floats");

// G consecutive lanes of one warp.
template <int G>
struct LaneGroup {
  static_assert(G == 8 || G == 16 || G == 32, "a lane group is 8, 16 or 32 lanes");
  unsigned mask;  // the group's lanes in the warp
  int lane;       // 0..G-1
  int base;       // the group's first lane in the warp

  __device__ LaneGroup() {
    const int wl = threadIdx.x & 31;
    lane = wl & (G - 1);
    base = wl & ~(G - 1);
    mask = (0xffffffffu >> (32 - G)) << base;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // the lowest lane whose `pred` holds, or -1
  __device__ __forceinline__ int first(bool pred) const {
    return __ffs((__ballot_sync(mask, pred) & mask) >> base) - 1;
  }
};

// The whole schedule for scenario b on the calling lane group; `s` is the
// scenario's scratch (group_scratch_floats floats of shared memory).
template <class M, int G>
__device__ void bank_solve_group(const M& m, const SolveArgs& a, int b, float* s) {
  const LaneGroup<G> grp;
  const int l = grp.lane;
  const int B = a.B, N = a.N;
  float* X = s;              // (N+1)*3
  float* U = X + 3 * (N + 1);  // 2N
  float* kff = U + 2 * N;    // 2N
  float* kfb = kff + 2 * N;  // 6N
  float* T = kfb + 6 * N;    // N stage terms
  float* W = T + N;          // records, or the candidates' slots
  StageRec* rec = reinterpret_cast<StageRec*>(W);
  const int slot_len = 5 * N;  // a candidate's controls (2N), then states X[1..N] (3N)
  const float lo_v = a.lo_v, hi_v = a.hi_v, lo_w = a.lo_w, hi_w = a.hi_w;
  const float int_lo_v = lo_v + a.eps_v, int_hi_v = hi_v - a.eps_v;
  const float int_lo_w = lo_w + a.eps_w, int_hi_w = hi_w - a.eps_w;

  // strictly interior start
  const Plane<const float> u0 = plane(a.u0, B, b);
  for (int k = l; k < N; k += G) {
    U[2 * k] = clip_nan(u0[2 * k], lo_v + 1e-3f * (hi_v - lo_v), hi_v - 1e-3f * (hi_v - lo_v));
    U[2 * k + 1] = clip_nan(u0[2 * k + 1], lo_w + 1e-3f * (hi_w - lo_w), hi_w - 1e-3f * (hi_w - lo_w));
  }
  grp.sync();

  // rollout of the first iterate; later iterates come from the line search
  {
    float px = m.x0[0], py = m.x0[1], th = m.x0[2];
    if (l == 0) {
      X[0] = px;
      X[1] = py;
      X[2] = th;
    }
    for (int k = 0; k < N; ++k) {
      m.step(px, py, th, U[2 * k], U[2 * k + 1]);
      if (l == 0) {
        X[3 * k + 3] = px;
        X[3 * k + 4] = py;
        X[3 * k + 5] = th;
      }
    }
  }
  grp.sync();

  float reg = a.reg_init;
  int done = 0;  // barrier stages this scenario has finished
  int n_it = 0, n_ls = 0;
  for (int t = 0; t < a.n_iters; ++t) {
    const int st = a.stage[t];
    if (done > st) continue;  // stage-level early exit, per scenario
    ++n_it;
    const float mu = a.mu[t];

    // the iterate's stage terms and derivatives, one stage per lane
    for (int k = l; k < N; k += G) {
      const float xp = X[3 * k], yp = X[3 * k + 1], tp = X[3 * k + 2];
      const float v = U[2 * k], w = U[2 * k + 1];
      T[k] = m.stage_cost(k, xp, yp, tp, v, w) - mu * barrier(a, v, w);
      StageRec r;
      r.j = m.jac(xp, yp, tp, v, w);
      r.g = m.grad(k, xp, yp, tp, v, w);
      const float sv_lo = v - lo_v, sv_hi = hi_v - v, sw_lo = w - lo_w, sw_hi = hi_w - w;
      r.g.lu0 -= mu * (1.f / sv_lo - 1.f / sv_hi);
      r.g.lu1 -= mu * (1.f / sw_lo - 1.f / sw_hi);
      r.g.luu00 += mu * (1.f / (sv_lo * sv_lo) + 1.f / (sv_hi * sv_hi));
      r.g.luu11 += mu * (1.f / (sw_lo * sw_lo) + 1.f / (sw_hi * sw_hi));
      rec[k] = r;
    }
    grp.sync();

    // the barrier cost, summed in k order
    float J = 0.f;
    for (int k = 0; k < N; ++k) J += T[k];
    J += m.terminal_cost(X[3 * N], X[3 * N + 1], X[3 * N + 2]);

    // backward Riccati sweep, every lane on the same records
    Value V = m.terminal_value(X[3 * N], X[3 * N + 1], X[3 * N + 2]);
    float dV1 = 0.f, dV2 = 0.f;
    for (int k = N - 1; k >= 0; --k) {
      const StageRec r = rec[k];
      float kf[2], K[2][3];
      riccati_step(V, r.j, r.g, reg, a.dt, kf, K, dV1, dV2);
      if (l == 0) {
        kff[2 * k] = kf[0];
        kff[2 * k + 1] = kf[1];
        for (int i = 0; i < 2; ++i)
          for (int c = 0; c < 3; ++c) kfb[(2 * k + i) * 3 + c] = K[i][c];
      }
    }

    // This scenario's Newton decrement is below tolerance: the rest of the
    // stage would be no-ops (never on a stage's first iteration).
    const float dec = -(dV1 + dV2);
    if (a.first[t] == 0 && dec - a.stage_tol * (1.f + fabsf(J)) < 0.f) done = st + 1;
    grp.sync();  // kff and kfb written; the records are dead, `work` takes the candidates

    // One candidate rollout at step size alpha, the plain line search's arithmetic;
    // its controls and states go to `slot`. Returns its barrier cost, NaN
    // made infinite.
    auto candidate = [&](float alpha, float* slot) {
      float cx = m.x0[0], cy = m.x0[1], cth = m.x0[2];
      float Jc = 0.f;
      for (int k = 0; k < N; ++k) {
        const float dx0 = cx - X[3 * k], dx1 = cy - X[3 * k + 1], dx2 = cth - X[3 * k + 2];
        const int f0 = 6 * k, f1 = 6 * k + 3;
        float v = U[2 * k] + alpha * kff[2 * k] + (kfb[f0] * dx0 + kfb[f0 + 1] * dx1 + kfb[f0 + 2] * dx2);
        float w = U[2 * k + 1] + alpha * kff[2 * k + 1] +
                  (kfb[f1] * dx0 + kfb[f1 + 1] * dx1 + kfb[f1 + 2] * dx2);
        v = clip_nan(v, int_lo_v, int_hi_v);
        w = clip_nan(w, int_lo_w, int_hi_w);
        Jc += m.stage_cost(k, cx, cy, cth, v, w) - mu * barrier(a, v, w);
        m.step(cx, cy, cth, v, w);
        slot[2 * k] = v;
        slot[2 * k + 1] = w;
        slot[2 * N + 3 * k] = cx;
        slot[2 * N + 3 * k + 1] = cy;
        slot[2 * N + 3 * k + 2] = cth;
      }
      Jc += m.terminal_cost(cx, cy, cth);
      return isnan(Jc) ? INFINITY : Jc;
    };

    // line search: lane l tries alpha = 2^-(r0 + l); the lowest passing wins
    int win = -1, win_lane = 0;
    for (int r0 = 0; r0 < a.n_alphas && win < 0; r0 += G) {
      const int ai = r0 + l;
      bool ok = false;
      if (ai < a.n_alphas) {
        const float alpha = ldexpf(1.f, -ai);
        const float Jc = candidate(alpha, W + l * slot_len);
        const float expected = -(alpha * dV1 + alpha * alpha * dV2);
        ok = Jc <= J - a.c1 * max_nan(expected, 0.f);
      }
      const int f = grp.first(ok);
      if (f >= 0) {
        win = r0 + f;
        win_lane = f;
      }
    }
    n_ls += win >= 0 ? win + 1 : a.n_alphas;
    grp.sync();  // the candidates' slots written
    if (win >= 0) {
      const float* slot = W + win_lane * slot_len;
      for (int i = l; i < 2 * N; i += G) U[i] = slot[i];
      for (int i = l; i < 3 * N; i += G) X[3 + i] = slot[2 * N + i];
      reg = fmaxf(reg * 0.5f, a.reg_min);
    } else {
      reg = fminf(reg * 10.f + a.reg_min, a.reg_max);
    }
    grp.sync();  // U and X of the next iterate
  }

  // true cost (no barrier) and the adjoint sweep's records at the final
  // iterate, whose rollout X already holds, one stage per lane
  for (int k = l; k < N; k += G) {
    const float xp = X[3 * k], yp = X[3 * k + 1], tp = X[3 * k + 2];
    const float v = U[2 * k], w = U[2 * k + 1];
    T[k] = m.stage_cost(k, xp, yp, tp, v, w);
    StageRec r;
    r.j = m.jac(xp, yp, tp, v, w);
    r.g = m.grad(k, xp, yp, tp, v, w);
    rec[k] = r;
  }
  grp.sync();
  float Jtrue = 0.f;
  for (int k = 0; k < N; ++k) Jtrue += T[k];
  Jtrue += m.terminal_cost(X[3 * N], X[3 * N + 1], X[3 * N + 2]);

  // adjoint sweep: projected-gradient KKT residual of the true cost
  const Value TV = m.terminal_value(X[3 * N], X[3 * N + 1], X[3 * N + 2]);
  float l0 = TV.vx0, l1 = TV.vx1, l2 = TV.vx2, kkt = 0.f;
  for (int k = N - 1; k >= 0; --k) {
    const StageRec r = rec[k];
    const Jac& jc = r.j;
    const Grad& g = r.g;
    const float v = U[2 * k], w = U[2 * k + 1];
    const float gu0 = g.lu0 + jc.bc * l0 + jc.bsn * l1;
    const float gu1 = g.lu1 + jc.b01 * l0 + jc.b11 * l1 + a.dt * l2;
    const float r0 = fabsf(v - clip_nan(v - gu0, lo_v, hi_v));
    const float r1 = fabsf(w - clip_nan(w - gu1, lo_w, hi_w));
    kkt = max_nan(kkt, max_nan(r0, r1));
    const float n2 = g.lx2 + jc.a02 * l0 + jc.a12 * l1 + l2;
    l0 = g.lx0 + l0;
    l1 = g.lx1 + l1;
    l2 = n2;
  }

  const Plane<float> Uo = plane(a.U, B, b), Xo = plane(a.X, B, b);
  for (int i = l; i < 2 * N; i += G) Uo[i] = U[i];
  for (int i = l; i < 3 * (N + 1); i += G) Xo[i] = X[i];
  if (l == 0) {
    a.cost[b] = Jtrue;
    a.kkt[b] = kkt;
    a.iters[b] = n_it;
    a.lsro[b] = n_ls;
  }
}

}  // namespace mpc
