"""ATE evaluation CLI.

Port of `apps/eval_ate.py` (ORB-SLAM3's evaluation/evaluate_ate_scale.py
with associate.py): associates an estimated TUM-format trajectory with the
ground truth by timestamp, Horn-aligns it (optionally with the optimal
monocular scale) and prints RMSE statistics. Host numpy only.

Usage:

    python -m orbslam3_tpu_torch.apps.eval_ate GT_FILE EST_FILE [--scale] [--max-dt 0.02]

GT accepts a EuRoC csv (ns timestamps) or a TUM txt.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from orbslam3_tpu_torch.evaluation import associate, umeyama_alignment


def load_traj(path: str):
    """Load TUM txt (`ts x y z ...`) or EuRoC csv (`ts_ns,x,y,z,...`).

    Stamps are nanoseconds in a comma-separated file or past 1e14. The JAX
    app reads only the second rule, so it takes a EuRoC csv whose stamps
    start near 0 s (the synthetic writers start at 100 s = 1e11 ns) for
    seconds and associates nothing."""
    rows, commas = [], False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            commas = commas or ',' in line
            parts = line.replace(',', ' ').split()
            rows.append([float(p) for p in parts[:4]])
    a = np.asarray(rows)
    ts = a[:, 0]
    if commas or ts.max() > 1e14:   # nanoseconds
        ts = ts * 1e-9
    return ts, a[:, 1:4]


def evaluate(gt_path: str, est_path: str, scale: bool = False,
             max_dt: float = 0.02) -> dict | None:
    """{"pairs", "rmse", "mean", "median", "std", "min", "max", "scale"}
    in metres, or None with fewer than 2 associated pairs."""
    ts_g, p_g = load_traj(gt_path)
    ts_e, p_e = load_traj(est_path)
    ia, ib = associate(ts_e, ts_g, max_dt=max_dt)
    if len(ia) < 2:
        return None
    est, gt = p_e[ia], p_g[ib]
    s, R, t = umeyama_alignment(est, gt, with_scale=scale)
    err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
    return dict(pairs=len(err), rmse=float(np.sqrt(np.mean(err ** 2))),
                mean=float(err.mean()), median=float(np.median(err)), std=float(err.std()),
                min=float(err.min()), max=float(err.max()), scale=float(s))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('gt')
    ap.add_argument('est')
    ap.add_argument('--scale', action='store_true',
                    help='optimal scale alignment (monocular)')
    ap.add_argument('--max-dt', type=float, default=0.02)
    args = ap.parse_args(argv)

    r = evaluate(args.gt, args.est, args.scale, args.max_dt)
    if r is None:
        print('error: fewer than 2 associated pairs', file=sys.stderr)
        return 2
    print(f'compared_pose_pairs {r["pairs"]} pairs')
    for key in ('rmse', 'mean', 'median', 'std', 'min', 'max'):
        print(f'absolute_translational_error.{key} {r[key]:.6f} m')
    if args.scale:
        print(f'alignment_scale {r["scale"]:.6f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
