"""Multi-process runtime: the process group the device mesh spans.

Port of :mod:`ros2_mpc_tpu.parallel.distributed`. The JAX package wires
hosts into one global device mesh with ``jax.distributed.initialize``; here
every process runs the same program and ``torch.distributed`` joins them.
After :func:`initialize`, :func:`~.mesh.make_mesh` spans every rank's
shards: each rank holds and solves only its own, and the bank metrics, the
sharded fleets' statistics and the swarm's per-tick gather go through the
process group (``~.mesh``).

Nothing on a machine names a cluster: the caller gives the address
(``init_method="tcp://localhost:<port>"``), the world size and the rank, or
``torchrun`` sets ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.
Without either, initialization is a no-op (one process).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch.distributed as dist

from ..device import resolve_device
from .mesh import default_slots

log = logging.getLogger("distributed")


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> dict:
    """Join the process group if one is configured.

    Resolution order: the explicit ``init_method`` (with ``world_size`` and
    ``rank``) > torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK`` > a single-process no-op. ``backend`` is the caller's choice,
    by default ``"nccl"`` where ``device`` is a card and ``"gloo"`` on the
    CPU; it is printed and never switched. ``device`` is where this
    process's shards will lie (``None``: the card, which raises without
    one).

    Returns ``{initialized, process_index, process_count, local_devices,
    global_devices, backend}``: the device counts are mesh slots, this
    process's default (:func:`~.mesh.default_slots`) and that times the
    process count."""
    dev = resolve_device(device)
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
        world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(env["RANK"]) if rank is None else rank
    initialized = dist.is_initialized()
    if init_method is not None and not initialized:
        if world_size is None or rank is None:
            raise ValueError("a process group needs world_size and rank beside init_method")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        print(f"distributed: backend {backend}, rank {rank} of {world_size}, {init_method}", flush=True)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
        initialized = True
    count = dist.get_world_size() if initialized else 1
    local = default_slots(None if device is None else dev)
    info = {
        "initialized": initialized,
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
        "backend": dist.get_backend() if initialized else None,
    }
    log.info("distributed runtime: %s", info)
    return info
