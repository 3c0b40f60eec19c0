"""The closed-loop tracking fleet (``make_tracking_fleet_rollout``): one
rollout of ``ticks`` ticks over a fleet drawn from the set-up pool, then the
next fleet.

For the check, ``check.robots`` robots are drawn from the seed at set-up,
and whether a rollout is recorded is drawn before it is issued (a reservoir
of one over the rollouts outside the traced stretch). A recorded rollout
keeps, of each tick's solver call, the drawn robots' rows alone, copied on
the side stream (a ``record`` of the bank solver that keeps no more)."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from yardstick import judge, traffic
from yardstick import reference as R
from yardstick.cells import F32, Cell as Base
from yardstick.cells import planes, program_settings, reservoir_keep, schedule


class Recorder:
    """Stands in for the bank solver's ``record`` list over one rollout."""

    def __init__(self, rows, side):
        self.rows, self.side, self.ticks = rows, side, []

    def take(self, *tensors):
        return self.side.run(lambda: tuple(t.index_select(0, self.rows) for t in tensors), *tensors)

    def append(self, item):
        th, warm, sol = item
        self.ticks.append(
            self.take(th["x0"], th["x_ref"], th["u_ref"], th["Q"], th["terminal_weight"], warm, sol.U, sol.X,
                      sol.cost, sol.kkt_residual)  # fmt: skip
        )


class Cell(Base):
    PLANNERS = ("tracking",)

    def setup(self):
        P, mix, dev, f = self.P, self.mix, self.device, self.config["formulation"]
        self.problem = self.planner.make_problem(P, self.params, self.config, program_settings(P, mix), dev)
        self.rollout = P.fleet.make_tracking_fleet_rollout(
            self.problem, n_ticks=mix["ticks"], dt=self.params.dt, goal_threshold=mix["goal_threshold"],
            device=dev, handoff_radius=f["handoff_radius"],
        )  # fmt: skip
        self.solver = self.rollout.engines[0]
        B, N = mix["B"], self.N
        self.pool = traffic.pool(mix, self.config, self.seed, dev)
        self.fleets = []
        for raw in self.pool:
            z = dict(raw, x_ref=torch.zeros((B, N, 3), dtype=F32, device=dev), u_ref=torch.zeros((B, N, 2), dtype=F32, device=dev))
            paths = {k: raw[k] for k in ("wps", "yaw", "speed", "omega")}
            self.fleets.append((self.planner.thetas(self.problem, z), paths))
        self.U0 = torch.zeros((B, N, 2), dtype=F32, device=dev)
        S = min(mix["check"]["robots"], B)
        self.rows = torch.as_tensor(np.sort(self.host_rng.choice(B, size=S, replace=False)), device=dev)
        self.rollout(*self.fleets[0], self.U0)  # every shape of the window
        self.sync()

    def window(self, seconds: float, stretch=None):
        mix, dev = self.mix, self.device
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        queue = deque()
        self.kept = None
        done = failed = seen = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if stretch is not None:
                t0 += stretch.turn(now, t0)
            if now - t0 >= seconds:
                break
            i = done % len(self.fleets)
            rec = None
            if stretch is None or stretch.state != "on":
                seen += 1
                if reservoir_keep(self.host_rng, seen, 1) is not None:
                    rec = Recorder(self.rows, self.side)
            self.solver.record = rec
            try:
                res = self.rollout(*self.fleets[i], self.U0)
            except (RuntimeError, ValueError):
                failed += 1
                done += 1
                continue
            finally:
                self.solver.record = None
            fs = res.final_states
            self.side.run(lambda fs=fs: nonfinite.add_((~torch.isfinite(fs)).any().to(torch.int64)), fs)
            done += 1
            if stretch is not None and stretch.state == "on":
                stretch.units += 1
            if rec is not None:
                self.kept = (i, rec.ticks, rec.take(fs)[0])
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                queue.append(ev)
                if len(queue) > mix["in_flight"]:
                    queue.popleft().synchronize()
        if stretch is not None and stretch.state == "on":
            stretch.stop()
        self.sync()
        elapsed = time.perf_counter() - t0
        ok = done - failed
        return {
            "attempted": done,
            "failed": failed + int(nonfinite),
            "seconds": elapsed,
            "metrics": {"robot_ticks_per_s": ok * mix["B"] * mix["ticks"] / elapsed},
        }

    def release(self):
        del self.rollout, self.solver, self.problem, self.fleets

    def check(self, control: bool = False) -> dict:
        mix, f, dev, N = self.mix, self.config["formulation"], self.device, self.N
        if self.kept is None or len(self.kept[1]) != mix["ticks"]:  # no rollout whose every tick was seen
            return {}
        i, record, final = self.kept
        raw = {k: v.index_select(0, self.rows) for k, v in self.pool[i].items()}
        T = len(record)
        S = self.rows.shape[0]
        extra = self.host_rng.choice(np.arange(1, T - 1), size=mix["check"]["ticks"] - 2, replace=False)
        solve_ticks = sorted({0, T - 1, *extra.tolist()})
        wps, yaw, speed, omega, goal = (raw[k] for k in ("wps", "yaw", "speed", "omega", "goal"))
        record = [tuple(t.float() for t in tick) for tick in record]
        x0s = [tick[0] for tick in record] + [final.float()]
        hq = torch.tensor(f["handoff_Q"], dtype=F32, device=dev)
        htw = torch.tensor(f["handoff_terminal_weight"], dtype=F32, device=dev)
        Q = torch.tensor(self.config["params"]["Q"], dtype=F32, device=dev)
        TW = torch.tensor(f["terminal_weight"], dtype=F32, device=dev)
        dt = self.params.dt
        low = torch.bfloat16 if control else F32
        window_gap, carry_gap = 0.0, 0.0
        latched = torch.zeros(S, dtype=torch.bool, device=dev)
        solve_in = []
        for t, (_, x_ref, u_ref, q, tw, warm, U, X, cost, kkt) in enumerate(record):
            x = x0s[t]
            to_goal = ((x[:, :2] - goal[:, :2]) ** 2).sum(-1)
            near = (to_goal < f["handoff_radius"] ** 2)[:, None]
            xr, ur = R.tracking_window(x[:, :2], goal, wps, yaw, speed, omega, N, f["window_latch"])
            Qr, TWr = torch.where(near, hq, Q), torch.where(near, htw, TW)
            if control:  # the window in the program's place, one precision down
                prog = [v.to(low).float() for v in R.tracking_window(
                    x[:, :2].to(low), goal.to(low), wps.to(low), yaw.to(low), speed.to(low), omega.to(low), N,
                    f["window_latch"])] + [Qr.to(low).float(), TWr.to(low).float()]  # fmt: skip
            else:
                prog = [x_ref, u_ref, q, tw]
            for a, b in zip(prog, (xr, ur, Qr, TWr)):
                window_gap = max(window_gap, judge._max((a - b).abs()))
            latched = latched | (to_goal < f["latch_radius"] ** 2)
            u0 = torch.where(torch.isfinite(U[:, 0]), U[:, 0], 0.0)
            u0 = torch.where(latched[:, None], 0.0, u0)
            nxt = R.plant(x, u0, dt)
            prog_next = R.plant(x.to(low), u0.to(low), dt).float() if control else x0s[t + 1]
            carry_gap = max(carry_gap, judge._max((prog_next - nxt).abs()))
            if t and not control:
                prev = record[t - 1][6]
                shift = torch.cat([prev[:, 1:], prev[:, -1:]], 1)
                carry_gap = max(carry_gap, judge._max((warm - shift).abs()))
            if t in solve_ticks:
                solve_in.append((x, *prog, warm, U, X, cost, kkt))
        cat = lambda j: torch.cat([s[j] for s in solve_in])  # noqa: E731
        n = len(solve_ticks)
        solve_raw = {
            "x0": cat(0), "x_ref": cat(1), "u_ref": cat(2), "Q": cat(3), "TW": cat(4),
            "ox": raw["ox"].repeat(n, 1), "oy": raw["oy"].repeat(n, 1),
        }  # fmt: skip
        p = self.planner.rows(self.config, solve_raw)
        sched = schedule(mix)
        warm = cat(5).permute(1, 2, 0).contiguous()
        ref = R.solve(p, warm, sched)
        if control:
            lowsol = R.solve(p.to(low), warm.to(low), sched)
            U, X, cost, kkt = lowsol["U"], lowsol["X"], lowsol["cost"], lowsol["kkt"]
        else:
            (U, X), cost, kkt = planes(cat(6), cat(7)), cat(8), cat(9)
        nums, kkt_true, cost_true = judge.claims(p, U, X, cost, kkt)
        nums["solve_gap"] = judge.solve_gap(ref["cost"], cost_true)
        nums["window_gap"], nums["carry_gap"] = window_gap, carry_gap
        self.reference_counts = {
            "P": traffic.live_prefix(solve_raw["ox"], solve_raw["oy"]).double().cpu().numpy(),
            "iters": ref["iters"].double().cpu().numpy(),
            "ls_rollouts": ref["ls_rollouts"].double().cpu().numpy(),
        }
        return nums
