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
from orbslam3_tpu_torch.imu.preintegration import ImuCalib, Preintegrated
from orbslam3_tpu_torch.place.vocab import Vocabulary
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState
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


def imu_calib(src, device=None) -> ImuCalib:
    """The port's `ImuCalib` from the JAX one (same field names)."""
    return ImuCalib(**{name: tensor(getattr(src, name), torch.float32, device)
                       for name in ImuCalib.__dataclass_fields__})


def preintegrated(src, device=None) -> Preintegrated:
    """The port's `Preintegrated` from the JAX one (same fields)."""
    return Preintegrated(*(tensor(x, torch.float32, device) for x in src))


def vocabulary(src) -> Vocabulary:
    """The port's `Vocabulary` from the JAX one (numpy arrays, copied)."""
    return Vocabulary(k=int(src.k), depth=int(src.depth),
                      levels=[np.array(lv, np.uint32) for lv in src.levels],
                      valid=[np.array(v, bool) for v in src.valid],
                      idf=np.array(src.idf, np.float32))


def keyframe_database(src, vocab: Vocabulary, device=None):
    """The port's `KeyFrameDatabase` holding the rows of a JAX one: the same
    rows at the same indices, the same free list."""
    from orbslam3_tpu_torch.place.database import KeyFrameDatabase
    M, F = src.kf_words.shape
    db = KeyFrameDatabase(vocab, max_keyframes=M, words_per_frame=F, device=device)
    db.kf_words = tensor(src.kf_words, torch.int32, device)
    db.kf_weights = tensor(src.kf_weights, torch.float32, device)
    db.active = np.array(src.active, bool)
    db.map_of = np.array(src.map_of, np.int64)
    db.slot_of = np.array(src.slot_of, np.int64)
    db._row = {(int(a), int(b)): int(r) for (a, b), r in src._row.items()}
    db._free = [int(r) for r in src._free]
    db._next_row = int(src._next_row)
    return db


# The SoA arrays a map carries, copied as they are (numpy on the host).
MAP_ARRAYS = (
    "kf_R", "kf_t", "kf_valid", "kf_ts", "kf_frame_id", "kf_uv", "kf_octave",
    "kf_angle", "kf_desc", "kf_feat_valid", "kf_obs_mp", "kf_prev", "kf_uid",
    "kf_vel", "kf_bias", "kf_uright",
    "mp_pos", "mp_desc", "mp_valid", "mp_normal", "mp_min_dist", "mp_max_dist",
    "mp_visible", "mp_found", "mp_first_kf", "mp_ref_kf", "mp_uid",
)


def map_state(src, device=None) -> MapState:
    """The port's `MapState` from a JAX `MapState` (or any object with its
    numpy arrays and counters): keyframe poses, features, observations,
    the stereo right coordinates, point positions, descriptors (uint32
    words, as both maps store them),
    normals, scale bands and counters, uids and cull anchors, and the
    inertial state (velocities, biases, the preintegration chain on
    `device`, the IMU-init flags and the last re-gauge). The covisibility
    product runs on `device`."""
    c = src.cfg
    cfg = MapConfig(max_keyframes=c.max_keyframes, max_points=c.max_points,
                    features_per_frame=c.features_per_frame,
                    keyframes_ceil=c.keyframes_ceil, points_ceil=c.points_ceil)
    m = MapState(cfg, map_id=src.map_id, device=device)
    for name in MAP_ARRAYS:
        setattr(m, name, np.array(getattr(src, name), copy=True))
    m._next_uid, m._next_mp_uid = int(src._next_uid), int(src._next_mp_uid)
    m.change_index = int(src.change_index)
    m.culled_anchor = {int(k): (int(a), np.array(R), np.array(t))
                       for k, (a, R, t) in src.culled_anchor.items()}
    m.kf_pre = {int(k): preintegrated(p, device) for k, p in src.kf_pre.items()}
    m.imu_initialized, m.bad_imu = bool(src.imu_initialized), bool(src.bad_imu)
    m.iba_stage, m.gauge_epoch = int(src.iba_stage), int(src.gauge_epoch)
    m.last_gauge = (None if src.last_gauge is None else
                    (np.array(src.last_gauge[0]), float(src.last_gauge[1])))
    return m
