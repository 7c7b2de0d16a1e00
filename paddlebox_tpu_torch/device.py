"""Device selection for the port's entry points.

The card is the default. The CPU is used only when a caller asks for it
(the parity tests do); a missing card with no explicit CPU request raises
instead of quietly training on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → the CUDA card (raises without one); otherwise the named
    device, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the card by "
                "default; pass device='cpu' to run on the host explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
