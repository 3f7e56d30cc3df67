"""Device choice for the entry points: the card unless the caller asks
for the CPU, and never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``"cuda"`` (the default everywhere) needs a CUDA device and raises
    without one; ``"cpu"`` runs the plain PyTorch versions of the kernels."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
