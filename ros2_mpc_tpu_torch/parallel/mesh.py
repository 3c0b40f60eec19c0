"""Shards of a scenario bank over devices and processes, and the bank solve
over them.

Port of :mod:`ros2_mpc_tpu.parallel.mesh`. MPC solves are embarrassingly
parallel across scenarios, so a bank is split along its leading axis into
``mesh.size`` equal contiguous shards, one per device slot of the mesh; each
shard is solved where it lies, and only the scalar telemetry (mean cost,
max KKT residual, converged fraction) crosses shards.

The JAX package names ``jax.devices()`` in a ``jax.sharding.Mesh`` and lets
GSPMD partition one jitted program. Here a :class:`Mesh` is a tuple of
``torch.device`` slots, one per shard of this process, and a step is a host
loop that issues each shard's solve on its device in turn (the calls return
before the device finishes, so the shards' devices work side by side).
Several slots may name one device: ``make_mesh(4, device="cuda:0")`` is four
shards on one card, solved one after the other on its stream, which
exercises the mesh on a one-card machine (its throughput ceiling is that of
one shard); ``make_mesh(device="cpu")`` is eight CPU shards, the
counterpart of the JAX suite's eight virtual CPU devices.

Across processes (:func:`~.distributed.initialize`), every rank holds the
same number of slots and the mesh spans them all: rank r holds global shards
``r * L .. r * L + L - 1``. Each rank solves only its own shards, and the
reductions and gathers go through the process group: ``dist.all_reduce`` and
``all_gather_into_tensor``. The gloo backend has no CUDA collectives, so
with gloo a CUDA tensor is staged through the host (a copy to the host and
back, which waits for the device); with NCCL it stays on the card. In one
process the reduction is a copy of each shard's partial result to the first
slot's device, with no read back to the host.

The engines (:func:`make_bank_solver`) are the JAX package's nine, by the
port's names: ``"vmap"``, ``"fast"``, ``"cuda"`` (K1, or K2 for a tracking
problem: the JAX package's ``"pallas"``), ``"mppi"``, ``"hybrid"``,
``"multistart"``, ``"two_pass"``, ``"multistart_bank"`` and
``"multistart_rescue"``. The TPU kernels' tile and lane options
(``interpret``, ``tile_s``, ``tile_l``, ``lanes``, ``rescue_tile_s``) are
not carried over: any shard size B >= 1 runs.

The sampling engines draw through
:class:`~ros2_mpc_tpu_torch.solver.mppi.ScenarioStreams`: each scenario's
noise is a hash of ``(seed, global scenario index, iteration, element)``, so
a bank draws the same numbers whether it is one shard or many, as the JAX
package folds the global index into its keys.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import indexed_device, resolve_device

SCENARIO_AXIS = "scenario"
# The TPU kernels' tile and lane options, which no port engine takes
# (ROADMAP "Not carried over").
TPU_ONLY_OPTS = ("interpret", "tile_s", "tile_l", "lanes", "rescue_tile_s")
ENGINES = (
    "vmap", "fast", "cuda", "mppi", "hybrid", "multistart", "two_pass", "multistart_bank", "multistart_rescue",
)  # fmt: skip
_SAMPLING = ("mppi", "hybrid", "multistart")
_COMPOSITES = ("two_pass", "multistart_bank", "multistart_rescue")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The device slots of a sharded bank: ``devices[i]`` holds global shard
    ``first_shard + i``. ``shape`` is the global extent along ``axis_names``
    (``(size,)`` by default); ``rank`` and ``world`` are this process's
    index and the process count."""

    devices: tuple
    axis_names: tuple = (SCENARIO_AXIS,)
    shape: tuple = ()
    rank: int = 0
    world: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device slot")
        object.__setattr__(self, "devices", tuple(indexed_device(d) for d in self.devices))
        if not self.shape:
            object.__setattr__(self, "shape", (self.size,))
        if int(np.prod(self.shape)) != self.size or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} over {self.axis_names} does not hold {self.size} shards")

    @property
    def size(self) -> int:
        """Shards over every process."""
        return len(self.devices) * self.world

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)


def _process() -> tuple:
    """(rank, world) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_slots(device) -> int:
    """How many slots :func:`make_mesh` gives this process for ``device``
    when ``n_devices`` is not given: one per visible card for the card
    (``None``; one per rank under a process group of several ranks), eight
    on the CPU, one on a named card."""
    if device is None:
        return 1 if _process()[1] > 1 else torch.cuda.device_count()
    return 8 if torch.device(device).type == "cpu" else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SCENARIO_AXIS, device=None) -> Mesh:
    """A 1D mesh of ``n_devices`` slots for this process (the default:
    :func:`default_slots`), spanning every rank of an initialized process
    group.

    * ``device=None``: the cards, slot i on ``cuda:i`` (raises without a
      card, or where ``n_devices`` exceeds the visible cards); under a
      process group of several ranks, this rank's own card
      (``LOCAL_RANK``, else the rank modulo the visible cards);
    * a named device (``"cpu"``, ``"cuda:0"``): every slot on it."""
    rank, world = _process()
    if device is None:
        resolve_device(None)  # raises without a card
    n = default_slots(device) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one slot, got n_devices={n_devices}")
    if device is None:
        count = torch.cuda.device_count()
        if world > 1:
            devices = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank % count))),) * n
        elif n > count:
            raise ValueError(
                f"{n} slots asked of {count} visible card(s): name a device (device='cuda:0') to put several on one"
            )
        else:
            devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devices = (torch.device(device),) * n
    return Mesh(devices, (axis_name,), rank=rank, world=world)


def make_host_chip_mesh(n_hosts: int, chips_per_host: int, device=None) -> Mesh:
    """The 2D ``("host", "chip")`` mesh: ``n_hosts * chips_per_host`` shards,
    host-major. Under a process group each rank is a host (``n_hosts`` must
    be the process count) with ``chips_per_host`` slots; in one process every
    slot is local. ``device`` as :func:`make_mesh`."""
    world = _process()[1]
    if world > 1 and n_hosts != world:
        raise ValueError(f"n_hosts={n_hosts} under a process group of {world} ranks")
    mesh = make_mesh(chips_per_host if world > 1 else n_hosts * chips_per_host, device=device)
    return dataclasses.replace(mesh, axis_names=("host", "chip"), shape=(n_hosts, chips_per_host))


# ------------------------------------------------------------ trees, shards


def _tree_map(fn, *trees):
    """``fn`` over the tensors of dicts, tuples and NamedTuples of the same
    structure (None stays None)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple):
        vals = [_tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*vals) if hasattr(t0, "_fields") else tuple(vals)
    return fn(*trees)


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


class Sharded(NamedTuple):
    """A bank split over a mesh: ``shards[i]`` is the tree of this process's
    slot i (global shard ``mesh.first_shard + i``) on ``mesh.devices[i]``,
    its bank axis at ``dim`` of every tensor."""

    shards: tuple
    mesh: Mesh
    dim: int = 0

    def gather(self, device=None):
        """The whole bank as one tree on ``device`` (default: the first
        slot's): this process's shards concatenated, and across a process
        group every rank's, in shard order."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)

        def cat(*leaves):
            t = torch.cat([x.to(dev) for x in leaves], dim=self.dim)
            return _all_gather(t, self.dim) if self.mesh.world > 1 else t

        return _tree_map(cat, *self.shards)


def shard_bank(tree, mesh: Mesh) -> Sharded:
    """Split every tensor of ``tree`` (a tensor, or a dict or NamedTuple of
    tensors) along its leading axis into ``mesh.size`` equal contiguous
    pieces and put this process's pieces on their slots' devices.
    Under a process group every rank passes the whole bank and keeps its
    own pieces. Raises ``ValueError`` where the bank does not divide."""
    if isinstance(tree, Sharded):
        if tree.mesh != mesh:
            raise ValueError("the bank is sharded over another mesh")
        return tree
    sizes = {int(v.shape[0]) for v in _leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"every leaf of a bank needs one leading size, got {sorted(sizes)}")
    (B,) = sizes
    if B % mesh.size:
        raise ValueError(f"a bank of B={B} scenarios does not split over a mesh of {mesh.size} shards")
    b = B // mesh.size
    shards = tuple(
        _tree_map(lambda v, lo=(mesh.first_shard + i) * b: v[lo : lo + b].to(dev), tree)
        for i, dev in enumerate(mesh.devices)
    )
    return Sharded(shards, mesh)


# ---------------------------------------------------------- cross-shard ops


def _staged(t: torch.Tensor) -> bool:
    """gloo has no CUDA collectives: its CUDA tensors go through the host."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _all_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    src = t.cpu() if _staged(t) else t.clone()
    dist.all_reduce(src, op=getattr(dist.ReduceOp, _OPS[op]))
    return src.to(t.device)


def _all_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order, on ``t``'s device."""
    src = t.movedim(dim, 0).contiguous()
    if _staged(src):
        src = src.cpu()
    out = src.new_empty((dist.get_world_size() * src.shape[0],) + tuple(src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src)
    return out.to(t.device).movedim(0, dim)


def reduce_parts(mesh: Mesh, parts, op: str) -> torch.Tensor:
    """One scalar over every shard from each local shard's partial
    (``op``: ``"sum"``, ``"max"`` or ``"min"``), on the first slot's device:
    each part copied there, reduced, then all-reduced across ranks."""
    first = mesh.devices[0]
    vals = torch.stack([p.to(first, non_blocking=True) for p in parts])
    out = {"sum": vals.sum, "max": vals.amax, "min": vals.amin}[op]()
    return _all_reduce(out, op) if mesh.world > 1 else out


def gather_rows(mesh: Mesh, parts) -> list:
    """The global table of per-shard rows: ``parts[i]`` is slot i's (b, ...)
    tensor; returns, for each slot, every shard's rows concatenated in shard
    order on that slot's device (one table per distinct device)."""
    first = mesh.devices[0]
    tables = {}
    if mesh.world > 1:
        tables[first] = _all_gather(torch.cat([p.to(first, non_blocking=True) for p in parts]))
    for d in mesh.devices:
        if d not in tables:
            tables[d] = (
                tables[first].to(d, non_blocking=True)
                if mesh.world > 1
                else torch.cat([p.to(d, non_blocking=True) for p in parts])
            )
    return [tables[d] for d in mesh.devices]


def bank_metrics(sols) -> dict:
    """Scalar telemetry of a whole bank: ``mean_cost``, ``max_kkt`` and
    ``frac_converged``, each reduced per shard, then across shards (a copy
    of each shard's partial to the first slot's device) and across ranks
    (``dist.all_reduce``). ``sols`` is a :class:`Sharded` Solution, or one
    Solution. Nothing is read back to the host."""
    if not isinstance(sols, Sharded):
        sols = Sharded((sols,), Mesh((sols.cost.device,)))
    mesh, shards = sols.mesh, sols.shards
    n = shards[0].cost.shape[0] * mesh.size
    return {
        "mean_cost": reduce_parts(mesh, [s.cost.sum() for s in shards], "sum") / n,
        "max_kkt": reduce_parts(mesh, [s.kkt_residual.amax() for s in shards], "max"),
        "frac_converged": reduce_parts(mesh, [s.converged.to(torch.float32).sum() for s in shards], "sum") / n,
    }


# ------------------------------------------------------------------ engines


def _engine(problem, engine, opts: dict):
    """``build(device) -> (solve(thetas, U0s, offset) -> Solution, bank
    solves it calls)`` of ``engine``; ``offset`` is the shard's first global
    scenario. Raises ValueError for an unknown engine, a problem kind it
    cannot solve, or options it does not take."""
    kind = getattr(problem, "kind", "point_stabilization")
    ocp, settings = problem.ocp, problem.settings
    if callable(engine):
        if opts:
            raise ValueError(f"a callable engine takes no engine_opts, got {sorted(opts)}")
        solve_bank = engine(ocp, settings)
        return lambda dev: ((lambda th, U, off: solve_bank(th, U)), (solve_bank,))
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected {' | '.join(map(repr, ENGINES))}")
    if engine == "vmap" and opts:
        raise ValueError(f"engine='vmap' takes no engine_opts, got {sorted(opts)}")
    if engine in _SAMPLING:
        seed = opts.pop("seed", 0)
        mppi_settings = opts.pop("settings", None)
        if opts:
            raise ValueError(f"engine='{engine}' takes seed=/settings=, got {sorted(opts)}")
    tpu = sorted(set(opts) & set(TPU_ONLY_OPTS))
    if tpu:
        raise ValueError(f"engine='{engine}' does not take {tpu}: the TPU kernels' tile and lane options are not carried over")
    if engine == "cuda" and kind not in ("point_stabilization", "tracking"):
        raise ValueError(
            f"engine='cuda' hard-codes the reference unicycle structure; problem kind {kind!r} runs at bank "
            "throughput via engine='fast' (the generic bank engine) or via 'vmap' | 'mppi' | 'hybrid' | 'multistart'"
        )
    if engine in _COMPOSITES and kind != "point_stabilization":
        raise ValueError(f"engine='{engine}' composes the point-stabilization bank kernels; problem kind {kind!r} needs another engine")

    if engine == "vmap":
        solve = torch.func.vmap(problem.solve)
        return lambda dev: ((lambda th, U, off: solve(th, U)), (solve,))
    if engine in _SAMPLING:
        from ..solver.mppi import MppiSettings, ScenarioStreams, make_hybrid_solver, make_mppi_solver, make_multistart_solver

        def build(dev):
            if engine == "mppi":
                solve = make_mppi_solver(ocp, mppi_settings or MppiSettings(), device=dev)
            else:
                make = make_hybrid_solver if engine == "hybrid" else make_multistart_solver
                solve = make(ocp, settings, mppi_settings, kind=kind, device=dev)
            return (lambda th, U, off: solve(th, U, ScenarioStreams(seed, off))), getattr(solve, "engines", ())

        return build

    def build(dev):
        if engine == "fast":
            from ..solver.batched import make_bank_solver_fast

            if opts:
                raise ValueError(f"engine='fast' takes no engine_opts, got {sorted(opts)}")
            solve = make_bank_solver_fast(ocp, settings)
        elif engine == "cuda":
            from ..solver.cuda_kernel import make_cuda_point_stab_solver, make_cuda_tracking_solver

            make = make_cuda_tracking_solver if kind == "tracking" else make_cuda_point_stab_solver
            solve = make(ocp, settings, **opts)
        elif engine == "two_pass":
            from ..solver.rescue import make_cuda_two_pass_point_stab

            solve = make_cuda_two_pass_point_stab(ocp, settings, **opts)
        else:
            from ..solver.multistart_bank import make_bank_multistart_solver
            from ..solver.rescue import make_multistart_two_pass_solver

            rest = dict(opts)
            inner = rest.pop("inner_engine", "cuda")
            make = make_bank_multistart_solver if engine == "multistart_bank" else make_multistart_two_pass_solver
            solve = make(ocp, settings, engine=inner, **rest)
        return (lambda th, U, off: solve(th, U)), getattr(solve, "engines", (solve,))

    return build


def make_bank_solver(problem, mesh: Mesh, engine="cuda", **engine_opts):
    """A scenario-bank solve over ``mesh``: ``step(thetas, U0s) -> (Sharded
    Solution, metrics)``. ``thetas``/``U0s`` are :func:`shard_bank` results
    over ``mesh`` (or whole banks, sharded on the way in); the Solutions stay
    sharded where they were solved, and ``metrics`` is
    :func:`bank_metrics`, 0-d tensors on the first slot's device.

    Engines, each run per shard:

    * ``"cuda"`` (the default): K1, or K2 for ``kind="tracking"``; opts are
      the kernel factory's (``stage_tol``, ``fast_sincos``);
    * ``"vmap"``: ``torch.func.vmap(problem.solve)``, no opts;
    * ``"fast"``: the generic bank engine (``solver/batched.py``), no opts;
    * ``"mppi"``, ``"hybrid"``, ``"multistart"``: the sampling engines,
      opts ``seed=`` (default 0) and ``settings=MppiSettings(...)``; the
      polishes of the last two on K1/K2; every scenario's draws from its
      global index (:class:`~ros2_mpc_tpu_torch.solver.mppi.ScenarioStreams`);
    * ``"two_pass"``: K1 first pass and compacted rescue, opts ``capacity=``
      (per shard) and ``rescue_settings=``;
    * ``"multistart_bank"``: arc-seeded starts, opts ``swing_fracs=``,
      ``inner_engine=`` (``"cuda"``, ``"fast"``, ``"vmap"``; default
      ``"cuda"``);
    * ``"multistart_rescue"``: multistart, rescue and KKT polish
      (:func:`~ros2_mpc_tpu_torch.solver.rescue.make_multistart_two_pass_solver`),
      opts ``capacity=`` (per shard), ``swing_fracs=``, ``rescue_settings=``,
      ``rescue_swing_fracs=``, ``polish_iters=``, ``polish_capacity=``,
      ``inner_engine=``;
    * a callable ``engine(ocp, settings) -> solve_bank``, no opts.

    The composites take point-stabilization problems only. ``step.engines``
    holds the bank solves the step calls (their launch counters)."""
    build = _engine(problem, engine, dict(engine_opts))
    per_device = {}
    for d in mesh.devices:
        if d not in per_device:
            per_device[d] = build(d)

    def step(thetas, U0s):
        th, U = shard_bank(thetas, mesh), shard_bank(U0s, mesh)
        b = U.shards[0].shape[0]
        sols = tuple(
            per_device[d][0](t, u, (mesh.first_shard + i) * b)
            for i, (d, t, u) in enumerate(zip(mesh.devices, th.shards, U.shards))
        )
        out = Sharded(sols, mesh)
        return out, bank_metrics(out)

    step.engines = tuple(e for _, engines in per_device.values() for e in engines)
    return step
