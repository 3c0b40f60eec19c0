"""What the run loops (``kinds/<kind>.py``) share: the system under test,
the configuration's settings, the reference's rows, the side stream, and
the base of every cell.

Each loop drives the program only through its public entry points and
keeps the benchmark's own device work (counting, keeping samples) on a side
stream, so that the program's stream holds the program's work alone.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import reference as R
from . import spec, traffic

F32 = torch.float32


def port():
    """The system under test: the PyTorch/CUDA package and nothing else."""
    import ros2_mpc_tpu_torch.config as config
    import ros2_mpc_tpu_torch.parallel.fleet as fleet
    import ros2_mpc_tpu_torch.solver.cuda_kernel as cuda_kernel
    import ros2_mpc_tpu_torch.solver.ilqr as ilqr
    import ros2_mpc_tpu_torch.solver.multistart_bank as multistart_bank
    import ros2_mpc_tpu_torch.solver.problems as problems

    return SimpleNamespace(
        config=config, fleet=fleet, cuda_kernel=cuda_kernel, ilqr=ilqr, multistart_bank=multistart_bank,
        problems=problems,
    )  # fmt: skip


def schedule(mix: dict) -> R.Schedule:
    return R.Schedule(**mix["schedule"])


def program_settings(P, mix: dict):
    return P.ilqr.SolverSettings(**mix["schedule"])


def program_params(P, config: dict):
    kv = {k: tuple(v) if isinstance(v, list) else v for k, v in config["params"].items()}
    return P.config.Params(**kv)


def column(vals, S: int, raw: dict):
    """A per-row (len(vals), S) float32 column of constants."""
    dev = raw["x0"].device
    return torch.tensor(vals, dtype=F32, device=dev)[:, None].expand(-1, S).contiguous()


def reference_rows(config: dict, kind: str, raw: dict, **extra) -> R.Rows:
    """The reference's problem for raw inputs (scenario axis first, as
    drawn), from the configuration's constants alone; ``extra`` holds what
    the planner adds (goal, or the reference windows)."""
    f = config["formulation"]
    S = raw["x0"].shape[0]
    dev = raw["x0"].device

    def const(v):
        return torch.full((S,), float(v), dtype=F32, device=dev)

    ox, oy = raw["ox"], raw["oy"]
    n_live = int(traffic.live_prefix(ox, oy).max()) if ox.numel() else 0
    return R.Rows(
        kind=kind,
        dt=float(config["params"]["dt"]),
        u_lo=(f["v_bounds"][0], f["w_bounds"][0]),
        u_hi=(f["v_bounds"][1], f["w_bounds"][1]),
        x0=raw["x0"].T.contiguous(),
        Q=raw["Q"].T.contiguous() if "Q" in raw else column(config["params"]["Q"], S, raw),
        R=column(f["R"], S, raw),
        rexp=const(f["reverse_exponent"]),
        gain=const(f["obstacle_gain"] * f["obstacle_weight"]),
        inv_ir2=const(1.0 / config["params"]["inflation_radius"] ** 2),
        ox=ox[:, :n_live].contiguous(),
        oy=oy[:, :n_live].contiguous(),
        **extra,
    )


def planes(sol_U, sol_X):
    """Program outputs (S, N, 2), (S, N+1, 3) -> scenario axis last."""
    return sol_U.permute(1, 2, 0).float(), sol_X.permute(1, 2, 0).float()


def reservoir_keep(rng, seen: int, size: int):
    """Reservoir sampling: the slot to put the ``seen``-th item in (1-based),
    or None to drop it, so that every item is kept with equal chance. The
    choice does not depend on the item, so it can be made before the item
    exists."""
    if seen <= size:
        return seen - 1
    j = int(rng.integers(0, seen))
    return j if j < size else None


class SideStream:
    """The benchmark's own device work, off the program's stream."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def run(self, fn, *tensors):
        if not self.cuda:
            return fn()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            out = fn()
        for t in tensors:
            t.record_stream(self.stream)
        return out


class Cell:
    """Shared by the run loops: the configuration and its planner, the mix,
    the seed. A loop that runs only some planners lists them in
    ``PLANNERS`` (None: any)."""

    PLANNERS = None

    def __init__(self, spec_: dict, seed: int, device):
        self.config, self.mix = spec_["config"], spec_["traffic"]
        name = self.config["formulation"]["planner"]
        if self.PLANNERS is not None and name not in self.PLANNERS:
            raise ValueError(
                f"traffic kind {self.mix['kind']!r} runs the planners {list(self.PLANNERS)}, not {name!r}: "
                "a configuration of another planner needs a kind of its own (kinds/<kind>.py)"
            )
        self.planner = spec.planner(name)
        self.seed = int(seed) % 2**63  # any whole number, as the generators take it
        self.device = torch.device(device)
        self.P = port()
        self.params = program_params(self.P, self.config)
        self.n_obs = self.params.n_obstacle_points
        self.N = self.params.N
        self.host_rng = np.random.default_rng([self.seed, 3])
        self.side = SideStream(self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def layer_run(self, stretch) -> SimpleNamespace:
        """What a per-layer reader sees: the traffic kind, the profiled
        stretch, the solver kernel's name and the run loop itself."""
        return SimpleNamespace(kind=self.mix["kind"], stretch=stretch, kernel=self.config["formulation"]["kernel"], cell=self)

    def per_call_work(self) -> tuple:
        """The roofline yardstick's operations and bytes of one solver call:
        the frozen ledger on the checked rows' live obstacle prefixes and
        the reference's executed iterations and rollouts, scaled to the
        call's ``B`` rows."""
        c = self.reference_counts
        flops, nbytes = self.planner.work(self.N, self.n_obs, c["P"], c["iters"], c["ls_rollouts"])
        B = self.mix["B"]
        return float(np.mean(flops)) * B, nbytes * B
