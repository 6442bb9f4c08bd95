"""Atlas checkpoint / resume.

Port of `orbslam3_tpu/slam_map/serialize.py`. ORB-SLAM3 serializes the
whole Atlas object graph (boost::serialization, `<name>.osa`) guarded by
an MD5 of the vocabulary; here the maps are flat structure-of-arrays, so
a checkpoint is one compressed `.npz` per atlas: every `MapState` array
under `map{mid}/{name}`, the map scalars, the per-map capacity tier, a
config fingerprint and the vocabulary fingerprint in a `__meta__` JSON
blob. The format is the JAX package's (FORMAT_VERSION 1), so an atlas
written by either package loads in the other.

Loading restores the saved maps as stored maps and spawns a fresh active
map on top (ORB-SLAM3's warm-start localization). What is not an array
(the keyframes' preintegrations `kf_pre`, the lock, the observers) is not
saved, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from orbslam3_tpu_torch import device as device_policy
from orbslam3_tpu_torch.slam_map.atlas import Atlas
from orbslam3_tpu_torch.slam_map.map_state import MapConfig, MapState

FORMAT_VERSION = 1

_MAP_SCALARS = ('_next_uid', 'change_index', 'imu_initialized', 'iba_stage',
                'map_id')


def _map_arrays(m: MapState) -> dict[str, np.ndarray]:
    return {k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)}


def config_fingerprint(cfg: MapConfig) -> str:
    return hashlib.md5(json.dumps(vars(cfg), sort_keys=True,
                                  default=str).encode()).hexdigest()


def vocab_fingerprint(vocab) -> str:
    """MD5 over the vocabulary's node arrays as contiguous bytes (ORB-SLAM3
    checksums its ORBvoc.txt); 'none' without a vocabulary."""
    if vocab is None:
        return 'none'
    h = hashlib.md5()
    for lv, vv in zip(vocab.levels, vocab.valid):
        h.update(np.ascontiguousarray(lv).tobytes())
        h.update(np.ascontiguousarray(vv).tobytes())
    return h.hexdigest()


def save_atlas(atlas: Atlas, path: str, vocab=None):
    """Write the whole atlas (every map, the active one too) to one .npz."""
    blobs = {}
    meta = {
        'format': FORMAT_VERSION,
        'config': vars(atlas.cfg),
        'config_md5': config_fingerprint(atlas.cfg),
        'vocab_md5': vocab_fingerprint(vocab),
        'active_id': atlas.active_id,
        'next_map_id': atlas._next_map_id,
        'map_ids': sorted(atlas.maps),
        'map_scalars': {},
        # maps grow independently: each is rebuilt at its own tier
        'map_config': {str(mid): vars(m.cfg) for mid, m in atlas.maps.items()},
        'extra': {},  # the JAX package's key; the port writes nothing there
    }
    for mid, m in atlas.maps.items():
        with m.lock:
            for name, arr in _map_arrays(m).items():
                blobs[f'map{mid}/{name}'] = arr.copy()
            meta['map_scalars'][str(mid)] = {
                s: (bool(v) if isinstance(v, bool) else int(v))
                for s, v in ((s, getattr(m, s)) for s in _MAP_SCALARS)}
    blobs['__meta__'] = np.frombuffer(json.dumps(meta, default=str).encode(), np.uint8)
    np.savez_compressed(path, **blobs)


def load_atlas(path: str, vocab=None, check_vocab: bool = True, device=None) -> Atlas:
    """Restore an atlas whose maps' covisibility products run on `device`
    (the card unless ``device="cpu"``): the saved maps become stored maps,
    and the active map is a fresh one. An array the file lacks keeps its
    initial value."""
    dev = device_policy.resolve(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z['__meta__']).decode())
        if meta['format'] != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {meta['format']} != {FORMAT_VERSION}")
        if check_vocab and meta['vocab_md5'] != vocab_fingerprint(vocab):
            raise ValueError('vocabulary fingerprint mismatch: the checkpoint was built '
                             'with a different vocabulary')
        cfg = MapConfig(**{k: int(v) for k, v in meta['config'].items()})
        atlas = Atlas(cfg, device=dev)
        atlas.maps.clear()  # drop the map the constructor made
        for mid in meta['map_ids']:
            mc = meta.get('map_config', {}).get(str(mid))
            mcfg = MapConfig(**{k: int(v) for k, v in mc.items()}) if mc else cfg
            m = MapState(mcfg, map_id=int(mid), device=dev)
            for name in _map_arrays(m):
                key = f'map{mid}/{name}'
                if key in z:
                    getattr(m, name)[...] = z[key]
            for s, v in meta['map_scalars'][str(mid)].items():
                setattr(m, s, v)
            atlas.maps[int(mid)] = m
        atlas._next_map_id = int(meta['next_map_id'])
        atlas.create_new_map()
    return atlas
