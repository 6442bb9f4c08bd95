"""Robust loss weights for iteratively reweighted least squares.

Port of `orbslam3_tpu/core/robust.py` (the Huber weight the pose
optimizer uses, and the chi-square gates).
"""

from __future__ import annotations

import torch

# chi-square 95% thresholds used throughout the reference optimizer
CHI2_MONO = 5.991  # 2 DoF
CHI2_STEREO = 7.815  # 3 DoF


def huber_weight(e2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel from the squared error:
    ``min(1, delta / e)``."""
    e = torch.sqrt(torch.clamp(e2, min=0.0))
    return torch.minimum(torch.ones_like(e), delta / torch.clamp(e, min=1e-12))
