"""Headless trajectory and map plots.

Port of `apps/draw_traj.py` (ORB-SLAM3's Examples/draw_traj.cc and its
MapDrawer, headless): matplotlib figures written to disk instead of a GL
window. matplotlib is imported only inside the plotting functions; where it
is missing (the machine with the card has none) they raise ImportError
with that reason.

Usage:

    python -m orbslam3_tpu_torch.apps.draw_traj --traj est.txt [--traj2 other.txt]
        [--gt gt.txt] [--atlas map.npz] [--map-out map.png] [--out traj.png]
        [--align] [--device cpu]

Trajectory files are TUM format (`ts x y z qx qy qz qw`); --gt may also be
a EuRoC GT csv. --atlas also scatter-plots the checkpoint's map points;
--map-out renders its keyframes, covisibility graph and points.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("draw_traj needs matplotlib, which is not installed here") from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _load_tum(path):
    rows = np.loadtxt(path)
    if rows.ndim == 1:
        rows = rows[None]
    return rows[:, 0], rows[:, 1:4]


def _load_gt(path):
    if path.endswith('.csv'):
        rows = np.genfromtxt(path, delimiter=',', comments='#')
        return rows[:, 0] * 1e-9, rows[:, 1:4]
    return _load_tum(path)


def draw_map(atlas_path: str, out_path: str, device=None):
    """Headless map view: keyframe centres, the covisibility graph (edge
    weight >= 15, like MapDrawer's graph), the temporal chain and the
    landmark cloud (MapDrawer::DrawKeyFrames + DrawMapPoints) to a PNG."""
    plt = _pyplot()
    from orbslam3_tpu_torch.slam_map import serialize

    atlas = serialize.load_atlas(atlas_path, check_vocab=False, device=device)
    maps = [m for m in atlas.maps.values() if m.n_keyframes > 0]
    if not maps:
        print('atlas has no populated maps')
        return
    fig, axes = plt.subplots(1, len(maps), figsize=(7 * len(maps), 6), squeeze=False)
    for ax, m in zip(axes[0], maps):
        live = m.mp_valid
        ax.scatter(m.mp_pos[live, 0], m.mp_pos[live, 1], s=0.3, c='gray', alpha=0.35,
                   label=f'{int(live.sum())} points')
        kfs = m.keyframe_ids()
        centers = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
        W = m.covis_weights(kfs)
        ai, bi = np.nonzero(np.triu(W >= 15, 1))
        for a, b in zip(ai, bi):
            ax.plot([centers[a, 0], centers[b, 0]], [centers[a, 1], centers[b, 1]], '-',
                    c='tab:green', lw=0.4, alpha=0.5)
        for i, k in enumerate(kfs):
            p = int(m.kf_prev[k])
            if p >= 0 and m.kf_valid[p]:
                j = int(np.nonzero(kfs == p)[0][0])
                ax.plot([centers[i, 0], centers[j, 0]], [centers[i, 1], centers[j, 1]], '-',
                        c='tab:blue', lw=0.9)
        ax.scatter(centers[:, 0], centers[:, 1], s=14, c='tab:blue', marker='s',
                   label=f'{len(kfs)} keyframes')
        ax.set_title(f'map {m.map_id}')
        ax.set_xlabel('x [m]')
        ax.set_ylabel('y [m]')
        ax.set_aspect('equal', 'datalim')
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=140)
    print('wrote', out_path)


def draw_traj(args) -> float | None:
    """The trajectory figure; returns the ATE (m) against --gt, else None."""
    plt = _pyplot()
    fig = plt.figure(figsize=(12, 5))
    ax_xy = fig.add_subplot(1, 2, 1)
    ax_z = fig.add_subplot(1, 2, 2)

    ts, p = _load_tum(args.traj)
    ate = None
    if args.gt:
        gts, gtp = _load_gt(args.gt)
        gt_at = np.stack([np.interp(ts, gts, gtp[:, k]) for k in range(3)], axis=-1)
        if args.align:
            from orbslam3_tpu_torch.evaluation import umeyama_alignment
            s, R, t = umeyama_alignment(p, gt_at, with_scale=True)
            p = s * (p @ R.T) + t
        ax_xy.plot(gtp[:, 0], gtp[:, 1], 'k--', lw=1, label='ground truth')
        ax_z.plot(gts - gts[0], gtp[:, 2], 'k--', lw=1)
        err = np.linalg.norm(p - gt_at, axis=1)
        ate = float(np.sqrt((err ** 2).mean()))
        fig.suptitle(f'ATE RMSE {ate * 1e3:.1f} mm over {len(ts)} frames')

    ax_xy.plot(p[:, 0], p[:, 1], '-', lw=1.2, label=os.path.basename(args.traj))
    ax_z.plot(ts - ts[0], p[:, 2], '-', lw=1.2)
    if args.traj2:
        t2, p2 = _load_tum(args.traj2)
        ax_xy.plot(p2[:, 0], p2[:, 1], '-', lw=1.0, label=os.path.basename(args.traj2))
        ax_z.plot(t2 - t2[0], p2[:, 2], '-', lw=1.0)

    if args.atlas:
        blob = np.load(args.atlas, allow_pickle=True)
        for key in blob.files:
            if key.endswith('mp_pos'):
                mp_valid_key = key.replace('mp_pos', 'mp_valid')
                pts = blob[key]
                if mp_valid_key in blob.files:
                    pts = pts[blob[mp_valid_key]]
                ax_xy.scatter(pts[:, 0], pts[:, 1], s=0.3, c='gray', alpha=0.4,
                              label='map points')
                break

    ax_xy.set_xlabel('x [m]')
    ax_xy.set_ylabel('y [m]')
    ax_xy.set_aspect('equal', 'datalim')
    ax_xy.legend(fontsize=8)
    ax_z.set_xlabel('t [s]')
    ax_z.set_ylabel('z [m]')
    fig.tight_layout()
    fig.savefig(args.out, dpi=140)
    print('wrote', args.out)
    return ate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--traj', required=True)
    ap.add_argument('--traj2', default='')
    ap.add_argument('--gt', default='')
    ap.add_argument('--atlas', default='')
    ap.add_argument('--out', default='traj.png')
    ap.add_argument('--align', action='store_true',
                    help='Sim3-align trajectory to GT before plotting')
    ap.add_argument('--map-out', default='',
                    help='also render the full map view (keyframes, covisibility graph, '
                         'spanning tree, map points) from --atlas to this PNG')
    from orbslam3_tpu_torch.apps.common import add_device_arg
    add_device_arg(ap)
    args = ap.parse_args(argv)

    if args.map_out and args.atlas:
        draw_map(args.atlas, args.map_out, device=args.device)
    draw_traj(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
