"""Device selection for the port's entry points.

They run on the CUDA card unless the caller asks for the CPU, and never
carry on silently on the CPU when no card is present."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card (raises without one); otherwise the device
    asked for, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
