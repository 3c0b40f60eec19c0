"""Signature parity of the port with the JAX package.

Walks both packages with ``ast`` (no import): for every public function and
every public method (and ``__init__``) of a public class in a module of
``ros2_mpc_tpu``, the module at the same path in ``ros2_mpc_tpu_torch``
(``solver/pallas_kernel.py`` is ``solver/cuda_kernel.py`` there) must have
it, with every JAX parameter, in JAX's order and of JAX's kind (positional
or keyword-only). The port may add parameters (``device``). What it leaves
out stands in ``NOT_CARRIED_OVER`` with its reason, and nowhere else.
"""

import ast
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "ros2_mpc_tpu"
PORT_PKG = ROOT / "ros2_mpc_tpu_torch"

_NO_CALLER = "no JAX caller outside its own module sets it; the port keeps the value as a constant"
_TPU_OPTS = "the TPU kernels' tile and lane options, which no port engine takes"
_TPU_LAYOUT = "the lane-major (B/128, 128) layout of XLA's TPU tiles; the port lays banks B-leading"
_FUSE = "the split of a composite into separately compiled stages, a work-around for a TPU compile helper"
_INTERPRET = "Pallas interpret mode; the port's kernels have plain PyTorch versions instead"
_FLEETS = ("make_fleet_rollout", "make_sharded_fleet_rollout", "make_tracking_fleet_rollout",
           "make_sharded_tracking_fleet_rollout")  # fmt: skip

# (module path, qualified name) -> {parameter: reason}; "*" is the whole function
NOT_CARRIED_OVER = {
    ("ops/mapping.py", "logodds_update"): dict.fromkeys(("l_occ", "l_free", "l_max"), _NO_CALLER),
    **{("parallel/fleet.py", f): {"**engine_opts": _TPU_OPTS} for f in _FLEETS},
    ("parallel/fleet.py", "make_generic_fleet_rollout"): {"pos_dims": _NO_CALLER, "**engine_opts": _TPU_OPTS},
    **{
        ("parallel/fleet.py", f): {"avoidance_radius": _NO_CALLER, "avoidance_weight": _NO_CALLER,
                                   "**engine_opts": _TPU_OPTS}
        for f in ("make_swarm_rollout", "make_sharded_swarm_rollout")
    },  # fmt: skip
    ("parallel/mesh.py", "make_bank_solver"): {"axis_names": _NO_CALLER},
    ("parallel/mesh.py", "shard_bank"): {"axis_names": _NO_CALLER},
    ("solver/multistart_bank.py", "make_bank_multistart_solver"): {"**engine_opts": _TPU_OPTS},
    ("parallel/distributed.py", "initialize"): dict.fromkeys(
        ("coordinator_address", "num_processes", "process_id"), "init_method, world_size and rank in torch's idiom"
    ),
    ("nodes/multiproc.py", "run_multiprocess"): {"role_platform": "role_device in the port"},
    **{
        (m, f): {"*": "make_cuda_* in the port"}
        for m, f in (
            ("solver/pallas_kernel.py", "make_pallas_point_stab_solver"),
            ("solver/pallas_kernel.py", "make_pallas_tracking_solver"),
            ("solver/rescue.py", "make_pallas_two_pass_point_stab"),
            ("solver/rescue.py", "make_pallas_two_pass_tracking"),
        )
    },
    ("solver/batched.py", "make_bank_solver_fast"): {"lanes": _TPU_LAYOUT},
    ("solver/batched.py", "make_bank_kkt_polish"): {"lanes": _TPU_LAYOUT},
    ("solver/rescue.py", "make_fast_polish_solver"): {"lanes": _TPU_LAYOUT, "fuse": _FUSE},
    ("solver/rescue.py", "make_multistart_two_pass_solver"): {"fuse": _FUSE, "**engine_opts": _TPU_OPTS},
    ("utils/roofline.py", "measure_vpu_peaks"): {"interpret": _INTERPRET},
    ("utils/roofline.py", "measure_loop_overhead"): {"interpret": _INTERPRET},
}


def _params(fn):
    """[(name, kind)] of a def, without self/cls; ``*args``/``**kw`` named
    with their stars."""
    a = fn.args
    out = [(x.arg, "positional") for x in a.posonlyargs + a.args]
    out += [(x.arg, "keyword-only") for x in a.kwonlyargs]
    if a.vararg:
        out.append(("*" + a.vararg.arg, "var"))
    if a.kwarg:
        out.append(("**" + a.kwarg.arg, "var"))
    return [p for p in out if p[0] not in ("self", "cls")]


def _public_defs(path):
    """{qualified name: [(param, kind)]} of a module's public functions and
    its public classes' public methods and ``__init__``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (sub.name == "__init__" or not sub.name.startswith("_")):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


def _port_path(rel):
    return PORT_PKG / str(rel).replace("pallas_kernel.py", "cuda_kernel.py")


def _gaps():
    """(missing, misordered, stale): JAX parameters the port lacks and the
    allow-list does not name; functions whose shared parameters differ in
    order or kind; allow-list entries the port has or JAX lacks."""
    missing, misordered, seen = [], [], set()
    for jf in sorted(JAX_PKG.rglob("*.py")):
        rel = jf.relative_to(JAX_PKG).as_posix()
        tf = _port_path(rel)
        if not tf.exists():
            missing.append((rel, "<module>", "*"))
            continue
        jdefs, tdefs = _public_defs(jf), _public_defs(tf)
        for name, jparams in jdefs.items():
            allowed = NOT_CARRIED_OVER.get((rel, name), {})
            seen.update((rel, name, p) for p in allowed)
            if name not in tdefs:
                if "*" not in allowed:
                    missing.append((rel, name, "*"))
                continue
            tparams = dict(tdefs[name])
            missing += [(rel, name, p) for p, _ in jparams if p not in tparams and p not in allowed]
            shared_j = [(p, k) for p, k in jparams if p in tparams]
            shared_t = [(p, k) for p, k in tdefs[name] if p in dict(jparams)]
            if shared_j != shared_t:
                misordered.append((rel, name, shared_j, shared_t))
    stale = []
    for (rel, name), allowed in NOT_CARRIED_OVER.items():
        jf, tf = JAX_PKG / rel, _port_path(rel)
        jdefs = _public_defs(jf) if jf.exists() else {}
        tdefs = _public_defs(tf) if tf.exists() else {}
        for p in allowed:
            gone_from_jax = name not in jdefs or (p != "*" and p not in dict(jdefs[name]))
            in_port = name in tdefs and (p == "*" or p in dict(tdefs[name]))
            if gone_from_jax or in_port or (rel, name, p) not in seen:
                stale.append((rel, name, p))
    return missing, misordered, stale


def test_port_has_every_public_parameter_of_the_jax_package():
    missing, misordered, stale = _gaps()
    assert not missing, f"JAX parameters the port lacks (add them, or a reason to NOT_CARRIED_OVER): {missing}"
    assert not misordered, f"shared parameters in another order or kind: {misordered}"
    assert not stale, f"NOT_CARRIED_OVER entries the port has or the JAX package lacks: {stale}"


# The arguments earlier slices left out and this port restores, each with the
# JAX package's default (held through ``inspect``, not by equal literals).
RESTORED = [
    ("compat", "TrackingMpc", "reference_parity"),
    ("compat", "PointStabilizationMpc", "reference_parity"),
    *(("nodes.live", "build_live_stack", p)
      for p in ("params", "map_image", "map_info", "start_pose", "global_costmap", "viz_period")),
    ("nodes.multiproc", "build_role_tasks", "map_image"),
    ("nodes.multiproc", "build_role_tasks", "map_info"),
    ("nodes.multiproc", "run_role", "params"),
    *(("nodes.multiproc", "run_multiprocess", p) for p in ("start_pose", "params", "roles")),
    *(("nodes.multi_robot", "MultiRobotSim", p) for p in ("params", "map_image", "map_info")),
    ("solver.mppi", "make_multistart_solver", "include_mppi"),
    *(("solver.rescue", "make_multistart_two_pass_solver", p)
      for p in ("rescue_settings", "rescue_swing_fracs", "polish_capacity")),
]  # fmt: skip


@pytest.mark.parametrize("module,name,param", RESTORED, ids=[".".join(r) for r in RESTORED])
def test_restored_argument_keeps_the_jax_default(module, name, param):
    import importlib

    jax_obj = getattr(importlib.import_module(f"ros2_mpc_tpu.{module}"), name)
    port_obj = getattr(importlib.import_module(f"ros2_mpc_tpu_torch.{module}"), name)
    jp = inspect.signature(jax_obj).parameters[param]
    tp = inspect.signature(port_obj).parameters[param]
    assert tp.kind == jp.kind
    if param == "params":  # the port's own Params dataclass, field for field
        import dataclasses

        assert (tp.default is None) == (jp.default is None)
        if jp.default is not None:
            assert dataclasses.asdict(tp.default) == dataclasses.asdict(jp.default)
    else:
        assert tp.default == jp.default, (tp.default, jp.default)
