"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  With no card, only an explicit ``"cpu"``
    runs: the entry points never fall back to the CPU by themselves."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a host
    clock read after it covers that work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
