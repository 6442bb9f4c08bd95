"""TUM RGB-D dataset: association loader and synthetic sequence writer.

Port of `orbslam3_tpu/datasets/tum_rgbd.py`, reading and writing PNGs with
the port's own codec (`datasets/imageio.py`) and rendering with the port's
`BoxScene`. The loader follows ORB-SLAM3's Examples/RGB-D/rgbd_tum.cc
`LoadImages`, which consumes an association file from TUM's
`associate.py` (lines "t_rgb rgb/<t>.png t_depth depth/<t>.png"); without
one, rgb.txt and depth.txt are matched here by nearest timestamp within
`max_difference` (associate.py's policy).

Depth convention: 16-bit PNGs scaled by `DepthMapFactor` (5000 for TUM),
as `Tracking::GrabImageRGBD` consumes them.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from orbslam3_tpu_torch.datasets import imageio


@dataclasses.dataclass
class TumRgbdSequence:
    """One TUM RGB-D sequence: associated rgb+depth pairs, lazy loading."""

    rgb_paths: list
    depth_paths: list
    image_ts: np.ndarray                  # (N,) seconds (rgb timestamps)
    gt_ts: np.ndarray | None = None
    gt_p: np.ndarray | None = None
    gt_q: np.ndarray | None = None        # wxyz

    def __len__(self):
        return len(self.rgb_paths)

    def read_image(self, i: int) -> np.ndarray:
        return imageio.imread(self.rgb_paths[i], grey=True)

    def read_depth(self, i: int) -> np.ndarray:
        """Raw 16-bit depth image as float32 (divide by DepthMapFactor for
        metres)."""
        return imageio.imread(self.depth_paths[i], grey=False).astype(np.float32)

    def gt_positions_at(self, ts: np.ndarray) -> np.ndarray:
        if self.gt_ts is None:
            raise ValueError("sequence has no ground truth")
        return np.stack([np.interp(ts, self.gt_ts, self.gt_p[:, k]) for k in range(3)],
                        axis=-1)


def _read_file_list(path: str) -> tuple[np.ndarray, list]:
    """TUM list file: '# comment' lines + 'timestamp filename' rows."""
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            parts = line.split()
            ts.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(ts, np.float64), names


def associate(ts_a: np.ndarray, ts_b: np.ndarray,
              max_difference: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp matching (TUM associate.py policy): all
    candidate pairs within max_difference, best-first, each side used once."""
    cands = []
    for i, ta in enumerate(ts_a):
        j0 = int(np.searchsorted(ts_b, ta))
        for j in (j0 - 1, j0, j0 + 1):
            if 0 <= j < len(ts_b) and abs(ta - ts_b[j]) < max_difference:
                cands.append((abs(ta - ts_b[j]), i, j))
    cands.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in cands:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out


def load_tum_rgbd(seq_dir: str, association_file: str | None = None,
                  max_difference: float = 0.02) -> TumRgbdSequence:
    """Load a TUM RGB-D sequence directory.

    With `association_file` (rgbd_tum.cc's usage) pairs come from its rows;
    otherwise rgb.txt/depth.txt are associated here."""
    if association_file:
        ts, rgb, dep = [], [], []
        with open(association_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('#'):
                    continue
                p = line.split()
                ts.append(float(p[0]))
                rgb.append(os.path.join(seq_dir, p[1]))
                dep.append(os.path.join(seq_dir, p[3]))
        ts = np.asarray(ts, np.float64)
    else:
        rts, rnames = _read_file_list(os.path.join(seq_dir, 'rgb.txt'))
        dts, dnames = _read_file_list(os.path.join(seq_dir, 'depth.txt'))
        pairs = associate(rts, dts, max_difference)
        ts = rts[[i for i, _ in pairs]]
        rgb = [os.path.join(seq_dir, rnames[i]) for i, _ in pairs]
        dep = [os.path.join(seq_dir, dnames[j]) for _, j in pairs]

    gt_ts = gt_p = gt_q = None
    gt_file = os.path.join(seq_dir, 'groundtruth.txt')
    if os.path.exists(gt_file):
        rows = []
        with open(gt_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('#'):
                    continue
                rows.append([float(x) for x in line.split()])
        arr = np.asarray(rows, np.float64)
        gt_ts = arr[:, 0]
        gt_p = arr[:, 1:4]
        # TUM order: tx ty tz qx qy qz qw -> store wxyz
        gt_q = arr[:, [7, 4, 5, 6]]
    return TumRgbdSequence(rgb, dep, ts, gt_ts, gt_p, gt_q)


TUM_CONFIG_TEMPLATE = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera1.k1: 0.0
Camera1.k2: 0.0
Camera1.p1: 0.0
Camera1.p2: 0.0
Camera.width: {width}
Camera.height: {height}
Camera.fps: {fps}
Camera.RGB: 1
Camera.bf: {bf}
Stereo.ThDepth: 40.0
RGBD.DepthMapFactor: {depth_factor}
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_synth_tum_rgbd(out_dir: str, n_frames: int = 80, width: int = 320,
                         height: int = 240, fx: float = 240.0,
                         fy: float = 240.0, fps: float = 20.0,
                         seed: int = 0, n_features: int = 500,
                         radius: float = 3.0, arc: float = 1.0,
                         depth_factor: float = 5000.0,
                         virtual_baseline: float = 0.08,
                         jitter_depth_ts: bool = True) -> str:
    """Render a TUM RGB-D layout sequence (rgb/ + depth/ + list files +
    groundtruth.txt + config.yaml) from the textured box scene with exact
    registered depth. Depth timestamps are slightly offset from rgb (like
    the real sensor) so the association path is exercised."""
    from orbslam3_tpu_torch.datasets.render import BoxScene, excited_trajectory
    from orbslam3_tpu_torch.datasets.synth_euroc import quat_wxyz

    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    scene = BoxScene.default(seed=seed)
    center = (scene.lo + scene.hi) / 2.0
    center = (float(center[0]), float(center[1]), float(center[2]) + 3.0)
    R_cw, t_cw, _, _, _, _ = excited_trajectory(
        n_frames, fps, 200.0, center, radius, arc, excitation=0.03, seed=seed)
    t0 = 1305031100.0   # TUM-era epoch-style stamps
    ts = t0 + np.arange(n_frames) / fps
    rng = np.random.default_rng(seed + 9)
    dt_off = (rng.uniform(0.001, 0.012, n_frames) if jitter_depth_ts
              else np.zeros(n_frames))

    os.makedirs(os.path.join(out_dir, 'rgb'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'depth'), exist_ok=True)
    rgb_rows = ["# color images", "# timestamp filename"]
    dep_rows = ["# depth images", "# timestamp filename"]
    gt_rows = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(n_frames):
        img, depth = scene.render(K, R_cw[i], t_cw[i], width, height,
                                  seed=seed * 1000 + i, return_depth=True)
        name = f"{ts[i]:.6f}.png"
        imageio.imwrite(os.path.join(out_dir, 'rgb', name), img)
        rgb_rows.append(f"{ts[i]:.6f} rgb/{name}")
        dname = f"{ts[i] + dt_off[i]:.6f}.png"
        d16 = np.clip(depth * depth_factor, 0, 65535).astype(np.uint16)
        imageio.imwrite(os.path.join(out_dir, 'depth', dname), d16)
        dep_rows.append(f"{ts[i] + dt_off[i]:.6f} depth/{dname}")
        Rwc = R_cw[i].T
        p = -Rwc @ t_cw[i]
        q = quat_wxyz(Rwc)
        gt_rows.append(f"{ts[i]:.6f} " + " ".join(f"{x:.6f}" for x in p)
                       + f" {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    for fn, rows in (('rgb.txt', rgb_rows), ('depth.txt', dep_rows),
                     ('groundtruth.txt', gt_rows)):
        with open(os.path.join(out_dir, fn), 'w') as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(out_dir, 'config.yaml'), 'w') as f:
        f.write(TUM_CONFIG_TEMPLATE.format(
            fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height,
            fps=fps, bf=virtual_baseline * fx, depth_factor=depth_factor,
            n_features=n_features))
    return out_dir
