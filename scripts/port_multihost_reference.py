"""The JAX package's multihost demo on the CPU, as one JSON line.

Runs the steps of `apps/run_multihost.py` with the JAX package, at the
arguments `chip_smoke.py`'s distributed phase gives the port's app
(`orbslam3_tpu_torch/apps/multihost.py`): by default the app's own, 120
frames, 1500 points, 8 BA iterations, 500 features at 640x480. Host 0
tracks frames [0, n/2 + n/8), host 1 frames [n/2 - n/8, n); host 1's map
goes through `map_to_blocks` -> `serialize_block` -> `fetch_remote_map`
(the bytes `send_map` puts on the wire) and is welded into host 0's atlas;
the merged problem is solved by `multihost.global_ba` on the 8-device
global mesh.

The steps run in one process, whose global mesh is its 8 virtual CPU
devices (the app's is 2 processes x 4). The app itself stops before its
joint BA: it ships the merged problem's `u_r` and `bf`, which are None,
as object arrays (`apps/run_multihost.py:129-130`), host 1's
`recv_arrays` refuses them (`allow_pickle=False`), and host 0 then times
out in gloo's context init. The port's app ships the ten monocular fields.

It prints one JSON line: the merged-map keyframe ATE after the joint BA
(mm, Sim3-aligned, as the app reports it), the welded keyframe count, each
segment's keyframes and points, the first and last BA cost and the wall
seconds. `chip_smoke.py` takes its bound on the port's merged-map ATE from
`ate_mm`.

Usage (from the repository root; a few minutes and ~1.5 GB on the CPU):

    python scripts/port_multihost_reference.py
    python scripts/port_multihost_reference.py --n-frames 80 --n-points 1000 --ba-iters 4
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to 8 virtual CPU devices)

import numpy as np  # noqa: E402

from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.distributed import multihost  # noqa: E402
from orbslam3_tpu.distributed.map_blocks import (fetch_remote_map, map_to_blocks,  # noqa: E402
                                                 serialize_block)
from orbslam3_tpu.engine.local_mapping import LocalMapper  # noqa: E402
from orbslam3_tpu.engine.tracking import Tracker, TrackerConfig  # noqa: E402
from orbslam3_tpu.evaluation import ate_rmse  # noqa: E402
from orbslam3_tpu.opt.ba import BAProblem  # noqa: E402
from orbslam3_tpu.slam_map.atlas import Atlas  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu.utils import synth  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frames", type=int, default=120)
    ap.add_argument("--n-points", type=int, default=1500)
    ap.add_argument("--ba-iters", type=int, default=8)
    args = ap.parse_args()
    t0 = time.perf_counter()
    cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480)
    cfg = MapConfig(max_keyframes=128, max_points=16384, features_per_frame=500)
    n = args.n_frames
    world = synth.make_world(n_points=args.n_points, seed=11)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=n, radius=3.0, arc=1.2 * np.pi)
    half, overlap = n // 2, n // 8
    rec = dict(n_frames=n, n_points=args.n_points, ba_iters=args.ba_iters)
    atlases = []
    for pid, seg in enumerate((range(0, half + overlap), range(half - overlap, n))):
        atlas = Atlas(cfg)
        m = atlas.active
        tracker = Tracker(cam, m, TrackerConfig(n_features=500),
                          local_mapper=LocalMapper(cam, m))
        for i in seg:
            feats, _ = synth.render_features(world, R_gt[i], t_gt[i], cam, capacity=500,
                                             seed=50_000 + i)
            tracker.process_features(feats, i * 0.05)
        rec[f"segment_{pid}"] = [m.n_keyframes, m.n_points]
        atlases.append(atlas)
        print(f"[{pid}] tracked segment: {m.n_keyframes} KFs {m.n_points} points",
              file=sys.stderr, flush=True)
    atlas, remote_src = atlases[0], atlases[1].active
    m = atlas.active
    wires = [serialize_block(b) for b in map_to_blocks(remote_src)]
    rid = atlas.adopt(fetch_remote_map(wires, cfg, map_id=99))
    kf_map = atlas.weld(m.map_id, rid, 1.0, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32))
    kfs = m.keyframe_ids()
    slot = np.full(m.cfg.max_keyframes, -1, np.int64)
    slot[kfs] = np.arange(len(kfs))
    mp_ids = np.nonzero(m.mp_valid)[0]
    pslot = np.full(m.cfg.max_points, -1, np.int64)
    pslot[mp_ids] = np.arange(len(mp_ids))
    kk, ss, mm = m.observations_of(mp_ids)
    fixed = np.zeros(len(kfs), bool)
    fixed[0] = True
    prob = BAProblem(
        R=m.kf_R[kfs], t=m.kf_t[kfs], points=m.mp_pos[mp_ids],
        kf_idx=slot[kk].astype(np.int32), lm_idx=pslot[mm].astype(np.int32),
        uv=m.kf_uv[kk, ss].astype(np.float32),
        info=(1.0 / 1.2 ** (2 * m.kf_octave[kk, ss])).astype(np.float32),
        valid=np.ones(len(kk), bool), fixed_kf=fixed,
        fixed_lm=np.zeros(len(mp_ids), bool))
    out, costs = multihost.global_ba(prob, cam, n_iters=args.ba_iters)
    centers = np.array([-out.R[i].T @ out.t[i] for i in range(len(kfs))])
    fids = m.kf_frame_id[kfs]
    gt_c = np.array([-R_gt[f].T @ t_gt[f] for f in fids])
    ate = ate_rmse(centers, gt_c, with_scale=True)
    rec.update(welded_kfs=len(kfs), remote_kfs=len(kf_map), points=len(mp_ids),
               observations=len(kk), ate_mm=float(ate * 1e3),
               cost=[float(costs[0]), float(costs[-1])],
               seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
