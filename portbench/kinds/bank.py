"""Independent scenario banks through the bank engine
(``multistart_bank.bank_engine("cuda", ..., kind=...)``, i.e.
``CudaBankSolver.__call__``): K1 or K2 as the configuration's planner
says. A pool of banks is drawn at set-up and cycled, at most ``in_flight``
calls queued ahead of the card; the window counts the rows whose reported
KKT residual is below the schedule's tolerance."""

from __future__ import annotations

import time
from collections import deque

import torch

from yardstick import judge, traffic
from yardstick import reference as R
from yardstick.cells import F32, Cell as Base
from yardstick.cells import planes, program_settings, schedule


class Cell(Base):
    def setup(self):
        P, mix, dev, config = self.P, self.mix, self.device, self.config
        self.problem = self.planner.make_problem(P, self.params, config, program_settings(P, mix), dev)
        self.solver = P.multistart_bank.bank_engine(
            "cuda", self.problem.ocp, self.problem.settings, kind=self.planner.ENGINE_KIND
        )
        self.pool = traffic.pool(mix, config, self.seed, dev)
        self.thetas = [self.planner.thetas(self.problem, b) for b in self.pool]
        self.U0 = torch.zeros((mix["B"], self.N, 2), dtype=F32, device=dev)
        self.solver(self.thetas[0], self.U0)  # the one shape of the window
        self.sync()

    def window(self, seconds: float, stretch=None):
        mix, dev = self.mix, self.device
        tol = schedule(mix).kkt_tol
        k = mix["check"]["rows_per_call"]
        B = mix["B"]
        conv = torch.zeros((), dtype=torch.int64, device=dev)
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        queue = deque()
        self.samples = []
        calls = failed = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if stretch is not None:
                t0 += stretch.turn(now, t0)
            if now - t0 >= seconds:
                break
            b = calls % len(self.thetas)
            try:
                sol = self.solver(self.thetas[b], self.U0)
            except (RuntimeError, ValueError):
                failed += 1
                calls += 1
                continue
            o = int(self.host_rng.integers(0, B - k + 1))

            def account(sol=sol, o=o):
                conv.add_((sol.kkt_residual < tol).sum())
                nonfinite.add_((~torch.isfinite(sol.U)).any().to(torch.int64))
                return tuple(t[o : o + k].clone() for t in (sol.U, sol.X, sol.cost, sol.kkt_residual))

            kept = self.side.run(account, sol.U, sol.X, sol.cost, sol.kkt_residual)
            self.samples.append((b, o, kept))
            calls += 1
            if stretch is not None and stretch.state == "on":
                stretch.units += 1
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(self.side.stream)
                queue.append(ev)
                if len(queue) > mix["in_flight"]:
                    queue.popleft().synchronize()
        if stretch is not None and stretch.state == "on":
            stretch.stop()
        self.sync()
        elapsed = time.perf_counter() - t0
        n_conv, n_bad = int(conv), int(nonfinite)
        self.converged_fraction = n_conv / max(1, (calls - failed) * B)
        return {
            "attempted": calls,
            "failed": failed + n_bad,
            "seconds": elapsed,
            "metrics": {"converged_solves_per_s": n_conv / elapsed},
        }

    def release(self):
        del self.thetas, self.solver, self.problem

    def chosen(self):
        """The sampled rows' raw inputs and the program's outputs."""
        S = self.mix["check"]["rows"]
        k = self.mix["check"]["rows_per_call"]
        flat = [(i, j) for i in range(len(self.samples)) for j in range(k)]
        pick = self.host_rng.choice(len(flat), size=min(S, len(flat)), replace=False)
        pick = sorted(flat[p] for p in pick)
        raw = {n: [] for n in self.pool[0]}
        out = [[], [], [], []]
        for i, j in pick:
            b, o, kept = self.samples[i]
            for n in raw:
                raw[n].append(self.pool[b][n][o + j])
            for t, lst in zip(kept, out):
                lst.append(t[j])
        raw = {n: torch.stack(v) for n, v in raw.items()}
        U, X, cost, kkt = (torch.stack(v) for v in out)
        return raw, U, X, cost, kkt

    def check(self, control: bool = False) -> dict:
        raw, U, X, cost, kkt = self.chosen()
        rows = self.planner.rows(self.config, raw)
        sched = schedule(self.mix)
        U0 = torch.zeros((self.N, 2, rows.S), dtype=F32, device=self.device)
        ref = R.solve(rows, U0, sched)
        if control:  # the reference in the program's place, one precision down
            low = R.solve(rows.to(torch.bfloat16), U0.to(torch.bfloat16), sched)
            U, X, cost, kkt = low["U"], low["X"], low["cost"], low["kkt"]
        else:
            U, X = planes(U, X)
        nums, kkt_true, _ = judge.claims(rows, U, X, cost, kkt)
        nums["kkt_rel_gap"] = judge.kkt_rel_gap(kkt, kkt_true, sched.kkt_tol)
        nums["conv_gap"] = judge.conv_gap(ref["kkt"], kkt_true, sched.kkt_tol)
        self.reference_counts = {
            "P": traffic.live_prefix(raw["ox"], raw["oy"]).double().cpu().numpy(),
            "iters": ref["iters"].double().cpu().numpy(),
            "ls_rollouts": ref["ls_rollouts"].double().cpu().numpy(),
        }
        return nums
