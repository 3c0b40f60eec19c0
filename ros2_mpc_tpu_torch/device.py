"""Where the port's entry points run: on the card unless the caller asks for
another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card,
    ``torch.device("cuda")``. Without a CUDA device ``None`` raises: nothing
    falls back to the CPU unless the caller names it (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ros2_mpc_tpu_torch runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def indexed_device(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the current card, as
    the tensors made there report it (``cuda:0``), so that it can key a
    table of per-device constants."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def device_constant(values):
    """``const(device, dtype=torch.float32)``: the vector ``values`` on
    ``device``, copied from the host once for each device and dtype and
    reused after. A copy on every call would block the host each time, a
    sync that a device loop (a fleet's ticks) must not make."""
    cache = {}

    def const(device, dtype=torch.float32):
        key = (indexed_device(device), dtype)
        if key not in cache:
            cache[key] = torch.tensor(values, dtype=dtype, device=device)
        return cache[key]

    return const
