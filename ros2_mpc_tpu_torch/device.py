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
