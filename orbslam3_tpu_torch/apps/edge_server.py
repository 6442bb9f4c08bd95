"""Edge-assisted SLAM server: the ORB-SLAM3 fork's `mono_inertial_edge` main.

Port of `apps/run_edge_server.py`. It starts a `Slam` (IMU_MONOCULAR) and
an `EdgeServer`, accepts phones that stream keypoints, descriptors and IMU
(SlamPktVI over TCP, 8080) and acoustic interval reports (8848), every
`--acoustic-period` seconds broadcasts the chirp "emit", converts interval
pairs to distances, fuses them with the SLAM positions
(`optimize_position_given_scale`) and rewrites the lanes' latest
trajectory entries; at the end it saves each client's trajectory.

Usage:

    python -m orbslam3_tpu_torch.apps.edge_server [--config yaml] [--port 8080]
        [--acoustic-port 8848] [--duration 60] [--out-dir traj_out]
        [--selftest] [--device cpu]

The card is the default device. With --selftest two fake phones
(`edge/client_sim.py`) replay a synthetic feature sequence in-process, so
the whole wire path runs without hardware.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def fuse_acoustic(server, dists, device=None) -> dict:
    """One acoustic fusion pass (the fork's mono_inertial_edge loop): each
    lane with a tracked frame is trilaterated on `device` (the server's
    `Slam`'s) against the other lanes' latest positions at scale 1 from
    `dists` (client 0's distances, as `cal_acoustic` returns them) and its
    latest trajectory entry is rewritten. Returns {lane id: (position
    before, anchors, distances, new position)}."""
    from orbslam3_tpu_torch.edge import acoustic
    lanes = list(server.lanes)
    entries = {ln.id: ln.last_entry() for ln in lanes}
    out = {}
    for ln in lanes:
        idx, pos = entries[ln.id]
        others = [entries[o.id][1] for o in lanes
                  if o.id != ln.id and entries[o.id][0] is not None]
        if idx is None or not others or not dists:
            continue
        anchors = np.asarray(others, np.float32)
        d = np.asarray(dists[:len(others)], np.float32)
        new_p = acoustic.optimize_position_given_scale(
            np.asarray(pos, np.float32), anchors, d, 1.0, device=device).cpu().numpy()
        ln.rewrite_traj(idx, new_p)
        out[ln.id] = (np.asarray(pos, np.float32), anchors, d, new_p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default='')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--acoustic-port', type=int, default=8848)
    ap.add_argument('--duration', type=float, default=60.0)
    ap.add_argument('--acoustic-period', type=float, default=2.0)
    ap.add_argument('--out-dir', default='traj_out')
    ap.add_argument('--features', type=int, default=1000)
    ap.add_argument('--device', default=None,
                    help="torch device (default: the card); 'cpu' to run on the CPU")
    ap.add_argument('--selftest', action='store_true',
                    help='run fake phone clients in-process')
    args = ap.parse_args(argv)

    from orbslam3_tpu_torch.core.camera import Camera
    from orbslam3_tpu_torch.edge.server import EdgeServer
    from orbslam3_tpu_torch.engine.system import Sensor, Slam, SystemConfig
    from orbslam3_tpu_torch.engine.tracking import TrackerConfig
    from orbslam3_tpu_torch.imu.preintegration import ImuCalib
    from orbslam3_tpu_torch.slam_map.map_state import MapConfig

    if args.config:
        from orbslam3_tpu_torch.config import Settings
        st = Settings.from_yaml(args.config, sensor='imu_monocular')
        cam = st.camera(device=args.device)
        sys_cfg = st.system_config(device=args.device)
    else:
        cam = Camera.pinhole(458.0, 458.0, 320.0, 240.0, width=640, height=480,
                             device=args.device)
        sys_cfg = SystemConfig(sensor=Sensor.IMU_MONOCULAR,
                               map=MapConfig(256, 20000, args.features),
                               tracker=TrackerConfig(n_features=args.features),
                               imu_calib=ImuCalib.create())

    slam = Slam(cam, sys_cfg, device=args.device)
    server = EdgeServer(slam.track_edge, host=args.host, slam_port=args.port,
                        acoustic_port=args.acoustic_port)
    print(f'edge server on {args.host}:{server.slam_port} (acoustic :{server.acoustic_port})',
          flush=True)

    phones = []
    if args.selftest:
        from orbslam3_tpu_torch.edge.client_sim import FakePhone
        from orbslam3_tpu_torch.utils import synth
        from orbslam3_tpu_torch.vision.frame import wire_arrays
        world = synth.make_world(n_points=3000, seed=2)
        R_gt, t_gt = synth.orbit_trajectory(n_frames=200, radius=3.0, arc=1.0)
        phones = [FakePhone(args.host, server.slam_port, server.acoustic_port, cid)
                  for cid in range(2)]
        print('selftest: 2 fake phones connected', flush=True)

    t_end = time.time() + args.duration
    last_emit = 0.0
    frame_i = 0
    try:
        while time.time() < t_end:
            now = time.time()
            # the acoustic schedule: broadcast "emit", the phones chirp and
            # report intervals, pending pairs become distances
            if now - last_emit >= args.acoustic_period and server.lanes:
                server.broadcast_emit()
                last_emit = now
                dists = server.cal_acoustic()
                if dists:
                    fuse_acoustic(server, dists, slam.device)
            if phones and frame_i < len(R_gt):
                for phone in phones:
                    feats, _ = synth.render_features(
                        world, R_gt[frame_i], t_gt[frame_i], cam, capacity=args.features,
                        seed=900 + frame_i + phone.id, device="cpu")
                    uv, desc = wire_arrays(feats)
                    phone.send_frame(frame_i, int((100 + frame_i * 0.05) * 1e9), uv, desc)
                frame_i += 1
                time.sleep(0.01)
            else:
                time.sleep(0.05)
    except KeyboardInterrupt:
        pass

    for p in phones:
        p.close()
    server.close()
    errors = [e for ln in server.lanes for e in ln.errors]
    with slam._edge_lock:  # no lane is inside track_edge from here on
        slam.shutdown()
        os.makedirs(args.out_dir, exist_ok=True)
        for cid in list(slam.trackers):
            path = os.path.join(args.out_dir, f'traj_client{cid}.txt')
            slam.save_trajectory_tum(path, client_id=cid)
            print('saved', path, flush=True)
    for e in errors:
        print(f'lane error: {e!r}', file=sys.stderr)
    return 1 if errors else 0


if __name__ == '__main__':
    sys.exit(main())
