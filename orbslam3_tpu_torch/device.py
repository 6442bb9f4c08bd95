"""Device policy of the port: the card by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point computes on.

    ``None`` means the card. Asking for CUDA on a machine without a card
    raises; there is no silent fallback to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "orbslam3_tpu_torch: CUDA requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
