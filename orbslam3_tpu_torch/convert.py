"""Carry state from the JAX package into the port.

The JAX side hands over numpy arrays (`jax.device_get` / `np.asarray`);
these helpers turn them into the port's objects on a device (the card
unless ``device="cpu"``). Packed descriptors arrive as uint32 words and are
reinterpreted bit for bit as int32.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.vision.frame import FrameFeatures


def words_to_int32(desc: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 packed words -> the same bits as int32."""
    return np.ascontiguousarray(np.asarray(desc, np.uint32)).view(np.int32)


def tensor(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=device_policy.resolve(device))


def camera(params, kind: str, width: int, height: int, device=None) -> Camera:
    """A camera from the JAX `Camera`'s params/kind/width/height."""
    return Camera(kind=kind, params=tensor(params, torch.float32, device),
                  width=int(width), height=int(height))


def map_points(mp_pos, mp_desc, mp_normal, mp_min_dist, mp_max_dist,
               device=None) -> dict:
    """Map-point arrays -> dict of tensors under the same names; `mp_desc`
    (uint32 words) becomes int32 words."""
    f32 = torch.float32
    return dict(
        mp_pos=tensor(mp_pos, f32, device),
        mp_desc=tensor(words_to_int32(mp_desc), torch.int32, device),
        mp_normal=tensor(mp_normal, f32, device),
        mp_min_dist=tensor(mp_min_dist, f32, device),
        mp_max_dist=tensor(mp_max_dist, f32, device),
    )


def frame_features(uv, uv_raw, response, angle, octave, desc, valid,
                   device=None) -> FrameFeatures:
    """`FrameFeatures` from the JAX `FrameFeatures` fields."""
    f32 = torch.float32
    return FrameFeatures(
        uv=tensor(uv, f32, device), uv_raw=tensor(uv_raw, f32, device),
        response=tensor(response, f32, device), angle=tensor(angle, f32, device),
        octave=tensor(octave, torch.int32, device),
        desc=tensor(words_to_int32(desc), torch.int32, device),
        valid=tensor(valid, torch.bool, device))
