"""Multi-host Atlas map-block exchange.

Port of `orbslam3_tpu/distributed/map_blocks.py`. A map crosses hosts as
keyframe blocks: fixed-schema dicts of contiguous array slices (keyframe
rows and the map points they reference), so transfers are bounded and
independent of host-side object graphs. The schema (version 1, the
`_KF_FIELDS` / `_MP_FIELDS` below) and the npz container are the JAX
package's, so a block written by either package reads in the other.

One deliberate difference: the JAX package's blocks carry neither the
points' uids nor the map's IMU flags, so a received map reissues point
uids from 0 and arrives un-initialized. The port's blocks also carry
`mp_uid` (per point row), `imu_initialized` and `iba_stage`; the JAX
reader copies only the fields it names and ignores them. On a block
without them (one the JAX package wrote) the port gives the received
valid points fresh uids in row order. Either way the received map's
point-uid counter is past every uid it holds.
"""

from __future__ import annotations

import io

import numpy as np

from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState

# keyframe-row arrays shipped per block (schema version 1)
_KF_FIELDS = ("kf_R", "kf_t", "kf_ts", "kf_frame_id", "kf_uv", "kf_octave",
              "kf_angle", "kf_desc", "kf_feat_valid", "kf_obs_mp",
              "kf_uright", "kf_vel", "kf_bias", "kf_prev", "kf_uid")
_MP_FIELDS = ("mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
              "mp_visible", "mp_found", "mp_first_kf", "mp_ref_kf")
# the port's addition per point row (the map's IMU flags ride in every block)
_MP_EXTRA = ("mp_uid",)


def _new_block(m: MapState, rows: np.ndarray) -> dict:
    blk = {"schema": 1, "map_id": m.map_id, "kf_rows": np.asarray(rows, np.int64),
           "imu_initialized": bool(m.imu_initialized), "iba_stage": int(m.iba_stage)}
    for f in _KF_FIELDS:
        blk[f] = getattr(m, f)[rows].copy()
    return blk


def _set_points(blk: dict, m: MapState, mp_ids: np.ndarray) -> None:
    blk["mp_rows"] = mp_ids
    for f in _MP_FIELDS + _MP_EXTRA:
        blk[f] = getattr(m, f)[mp_ids].copy()


def map_to_blocks(m: MapState, block_kfs: int = 64) -> list[dict]:
    """Split a map into transport blocks of <= block_kfs keyframes each.

    Every block carries its keyframe rows plus the map-point rows those
    keyframes observe (a point shared between blocks is sent once, in the
    first block that references it). Valid points observed by no keyframe
    are appended to the final block, so blocks_to_map(map_to_blocks(m))
    equals m on every valid row."""
    kfs = m.keyframe_ids()
    sent_mp = np.zeros(m.cfg.max_points, bool)
    blocks = []
    for start in range(0, len(kfs), block_kfs):
        rows = kfs[start:start + block_kfs]
        blk = _new_block(m, rows)
        obs = m.kf_obs_mp[rows]
        mp_ids = np.unique(obs[obs >= 0])
        mp_ids = mp_ids[m.mp_valid[mp_ids] & ~sent_mp[mp_ids]]
        sent_mp[mp_ids] = True
        _set_points(blk, m, mp_ids)
        blocks.append(blk)
    leftover = np.flatnonzero(m.mp_valid & ~sent_mp)
    if len(leftover):
        if not blocks:
            blk = _new_block(m, np.zeros(0, np.int64))
            _set_points(blk, m, np.zeros(0, np.int64))
            blocks.append(blk)
        blk = blocks[-1]
        _set_points(blk, m, np.concatenate([blk["mp_rows"], leftover]))
    return blocks


def blocks_to_map(blocks: list[dict], cfg: MapConfig, map_id: int = 0,
                  device=None) -> MapState:
    """Reassemble a MapState from received blocks (row ids preserved), its
    covisibility product on `device` (the card unless ``device="cpu"``)."""
    m = MapState(cfg, map_id=map_id, device=device)
    max_uid = 0
    with_uids = True
    for blk in blocks:
        if int(blk["schema"]) != 1:
            raise ValueError(f"map block schema {blk['schema']} != 1")
        rows = blk["kf_rows"]
        for f in _KF_FIELDS:
            getattr(m, f)[rows] = blk[f]
        m.kf_valid[rows] = True
        mp_rows = blk["mp_rows"]
        for f in _MP_FIELDS:
            getattr(m, f)[mp_rows] = blk[f]
        m.mp_valid[mp_rows] = True
        if "mp_uid" in blk:
            m.mp_uid[mp_rows] = blk["mp_uid"]
        else:
            with_uids = False
        if len(rows):
            max_uid = max(max_uid, int(blk["kf_uid"].max()))
        if "imu_initialized" in blk:
            m.imu_initialized = bool(blk["imu_initialized"])
            m.iba_stage = int(blk["iba_stage"])
    m._next_uid = max_uid + 1
    valid = np.flatnonzero(m.mp_valid)
    if not with_uids:  # a block of the JAX package's: fresh uids in row order
        m.mp_uid[:] = -1
        m.mp_uid[valid] = np.arange(len(valid))
    m._next_mp_uid = int(m.mp_uid.max()) + 1 if len(valid) else 0
    m.change_index += 1
    return m


def serialize_block(blk: dict) -> bytes:
    """One block -> bytes (npz container) for socket/file transport."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: np.asarray(v) for k, v in blk.items()})
    return buf.getvalue()


def deserialize_block(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        blk = {k: z[k] for k in z.files}
    blk["schema"] = int(blk["schema"])
    blk["map_id"] = int(blk["map_id"])
    return blk


def fetch_remote_map(blocks_bytes: list[bytes], cfg: MapConfig, map_id: int = 0,
                     device=None) -> MapState:
    """Receiving side of a cross-host merge: wire blocks -> MapState, ready
    for `Atlas.weld`."""
    return blocks_to_map([deserialize_block(b) for b in blocks_bytes], cfg,
                         map_id=map_id, device=device)
