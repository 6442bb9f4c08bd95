"""Batched DLT triangulation.

Port of `orbslam3_tpu/vision/triangulate.py`: the stacked 4x4 DLT system of
every match is solved by one batched SVD, its null vector dehomogenized.
"""

from __future__ import annotations

import torch


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor):
    """Linear triangulation.

    P1, P2: (3,4) projection matrices; x1, x2: (..., 2) observations in the
    same units. Returns (..., 3) points and the smallest singular value (a
    conditioning signal).
    """
    A = torch.stack(torch.broadcast_tensors(
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ), dim=-2)  # (..., 4, 4)
    _, s, vh = torch.linalg.svd(A)
    X = vh[..., 3, :]
    w = X[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w_safe[..., None], s[..., 3]


def projection_matrix(R: torch.Tensor, t: torch.Tensor, K: torch.Tensor | None = None):
    """(3,4) projection of the world->camera pose (R, t), K-premultiplied
    when K is given."""
    P = torch.cat([R, t[..., None]], dim=-1)
    return P if K is None else K @ P
