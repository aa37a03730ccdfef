"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card. A CUDA device that is not there raises: the
    port never carries on silently on the CPU. ``"cpu"`` must be asked for
    explicitly (the parity tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (device=None means 'cuda') but no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return dev
