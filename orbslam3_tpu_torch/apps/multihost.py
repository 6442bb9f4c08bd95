"""Two-host SLAM demo: a cross-host map weld, then a joint sharded BA.

Port of `apps/run_multihost.py`:

  1. Both processes join one `torch.distributed` process group
     (`distributed.multihost.initialize`).
  2. Each tracks its own segment of one orbit through a shared synthetic
     world (feature-level frames, `utils.synth`): host 0 frames
     [0, n/2 + n/8), host 1 frames [n/2 - n/8, n).
  3. Host 1 streams its map to host 0 over TCP as keyframe blocks
     (`distributed.host_exchange`); host 0 adopts it and welds it into its
     Atlas (`Atlas.weld`), then sends the merged BA problem back.
  4. Both solve it together with the landmark-sharded Schur BA, one
     landmark shard per rank (`distributed.multihost.global_ba`); host 0
     reports the merged map's keyframe ATE.

It prints the JAX app's marker lines (`joined: N`, `welded`, `MULTIHOST OK
... ate_mm=`) and, per process, its kernel launches. The merged problem
carries the ten monocular fields of `BAProblem`; the JAX app also ships
`u_r` and `bf`, which are None, as object arrays, which its receiver
refuses.

Run, in two shells (the card and NCCL by default; two ranks on one card
need ``--backend gloo``, since NCCL refuses two ranks on one device):

    python -m orbslam3_tpu_torch.apps.multihost --process-id 0 --coordinator localhost:9801
    python -m orbslam3_tpu_torch.apps.multihost --process-id 1 --coordinator localhost:9801

and on the CPU add ``--device cpu --backend gloo`` to both.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

CAMERA = (458.0, 458.0, 320.0, 240.0)  # fx fy cx cy at 640x480
N_FEATURES = 500


def track_segment(pid: int, n_frames: int, n_points: int, device):
    """Host `pid`'s tracking session: its segment of the shared orbit.
    Returns (atlas, ground-truth R_cw, t_cw of every frame)."""
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.engine.local_mapping import LocalMapper
    from orbslam3_tpu_torch.engine.tracking import Tracker, TrackerConfig
    from orbslam3_tpu_torch.slam_map.atlas import Atlas
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig
    from orbslam3_tpu_torch.utils import synth
    cam = Camera.pinhole(*CAMERA, width=640, height=480, device=device)
    cfg = MapConfig(max_keyframes=128, max_points=16384, features_per_frame=N_FEATURES)
    world = synth.make_world(n_points=n_points, seed=11)
    R_gt, t_gt = synth.orbit_trajectory(n_frames=n_frames, radius=3.0, arc=1.2 * np.pi)
    half, overlap = n_frames // 2, n_frames // 8
    seg = range(0, half + overlap) if pid == 0 else range(half - overlap, n_frames)
    atlas = Atlas(cfg, device=device)
    m = atlas.active
    tracker = Tracker(cam, m, TrackerConfig(n_features=N_FEATURES),
                      local_mapper=LocalMapper(cam, m, device=device), device=device)
    for i in seg:
        feats, _ = synth.render_features(world, R_gt[i], t_gt[i], cam, capacity=N_FEATURES,
                                         seed=50_000 + i, device=device)
        tracker.process_features(feats, i * 0.05)
    return atlas, R_gt, t_gt


def merged_problem(m):
    """The BA problem over every keyframe and valid point of map `m` (the
    first keyframe fixed), as numpy arrays, and the keyframe slots."""
    from orbslam3_tpu_torch.opt.ba import BAProblem
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
        kf_idx=slot[kk], lm_idx=pslot[mm], uv=m.kf_uv[kk, ss].astype(np.float32),
        info=(1.0 / 1.2 ** (2 * m.kf_octave[kk, ss])).astype(np.float32),
        valid=np.ones(len(kk), bool), fixed_kf=fixed, fixed_lm=np.zeros(len(mp_ids), bool))
    return prob, kfs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--process-id', type=int, required=True)
    ap.add_argument('--coordinator', default='localhost:9801')
    ap.add_argument('--map-port', type=int, default=9802)
    ap.add_argument('--n-frames', type=int, default=120)
    ap.add_argument('--n-points', type=int, default=1500)
    ap.add_argument('--ba-iters', type=int, default=8)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--backend', default='nccl', choices=('nccl', 'gloo'))
    args = ap.parse_args(argv)
    pid = args.process_id

    from orbslam3_tpu_torch import _build
    from orbslam3_tpu_torch import device as device_policy
    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.distributed import host_exchange as hx
    from orbslam3_tpu_torch.distributed import multihost
    from orbslam3_tpu_torch.evaluation import ate_rmse
    from orbslam3_tpu_torch.opt.ba import BAProblem

    dev = device_policy.resolve(args.device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    multihost.initialize(args.coordinator, num_processes=2, process_id=pid,
                         backend=args.backend)
    try:
        world = torch.distributed.get_world_size()
        print(f'[{pid}] joined: {world} ranks ({args.backend}, {dev})', flush=True)

        # ---- 2. track my segment of the shared world
        atlas, R_gt, t_gt = track_segment(pid, args.n_frames, args.n_points, dev)
        m = atlas.active
        print(f'[{pid}] tracked segment: {m.n_keyframes} KFs {m.n_points} points',
              flush=True)

        # ---- 3. host 1 ships its map to host 0; host 0 welds
        if pid == 1:
            sock = hx.connect(args.map_port)
        else:
            sock = hx.serve_once(args.map_port)
        with sock:
            if pid == 1:
                hx.send_map(sock, m)
                _, arrays = hx.recv_arrays(sock)  # the merged BA problem
                prob = BAProblem(**arrays)
            else:
                rid = atlas.adopt(hx.recv_map(sock, m.cfg, map_id=99, device=dev))
                n_before = m.n_keyframes
                # both sessions share the world's gauge here; a production
                # merge takes the seam Sim3 from place recognition
                kf_map = atlas.weld(m.map_id, rid, 1.0, np.eye(3, dtype=np.float32),
                                    np.zeros(3, np.float32))
                print(f'[{pid}] welded {len(kf_map)} remote KFs into map {m.map_id} '
                      f'({n_before} -> {m.n_keyframes} KFs)', flush=True)
                prob, kfs = merged_problem(m)
                hx.send_arrays(sock, 'merged_ba',  # u_r and bf are None: mono
                               {k: v for k, v in prob._asdict().items() if v is not None})

        # ---- 4. the joint solve, one landmark shard per rank
        cam = Camera.pinhole(*CAMERA, width=640, height=480, device=dev)
        t0 = time.perf_counter()
        out, costs = multihost.global_ba(prob, cam, n_iters=args.ba_iters, device=dev)
        wall = time.perf_counter() - t0
        print(f'[{pid}] joint BA on {world} ranks: {len(prob.R)} KFs, {len(prob.points)} '
              f'points, {len(prob.kf_idx)} observations; cost {float(costs[0]):.1f} -> '
              f'{float(costs[-1]):.1f} in {wall:.2f}s', flush=True)
        if not costs[-1] <= costs[0]:
            raise RuntimeError(f'joint BA diverged: cost {costs[0]} -> {costs[-1]}')
        print(f'[{pid}] launches: {json.dumps(_build.snapshot(), sort_keys=True)}',
              flush=True)

        if pid == 0:
            m.kf_R[kfs] = out.R.astype(np.float32)
            m.kf_t[kfs] = out.t.astype(np.float32)
            centers = np.einsum('kji,kj->ki', out.R, -out.t)  # -R^T t
            # as the JAX app: the truth at each keyframe's frame id, which
            # for host 1's keyframes counts from its own first frame
            gt_c = np.array([-R_gt[f].T @ t_gt[f] for f in m.kf_frame_id[kfs]])
            ate = ate_rmse(centers, gt_c, with_scale=True)
            print(f'[{pid}] merged-map KF ATE after joint BA: {ate * 1e3:.1f} mm over '
                  f'{len(kfs)} KFs', flush=True)
            print(f'MULTIHOST OK welded_kfs={len(kfs)} ate_mm={ate * 1e3:.3f}', flush=True)
        else:
            print('MULTIHOST OK (worker)', flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
