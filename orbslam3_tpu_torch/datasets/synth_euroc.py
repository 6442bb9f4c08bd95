"""Synthetic EuRoC-format sequence writer.

Port of `orbslam3_tpu/datasets/synth_euroc.py` on the port's renderer
(`datasets/render.py`: `BoxScene`, `excited_trajectory`) and PNG codec
(`datasets/imageio.py`). It writes a full ASL-layout dataset (cam0 PNGs +
data.csv, imu0/data.csv, state_groundtruth_estimate0/data.csv,
config.yaml), so the on-disk path (directory loader, PNG decode, IMU csv
windowing, YAML settings, image front end) runs end to end with exact
ground truth, in the layout ORB-SLAM3's Examples/Monocular-Inertial/
mono_inertial_euroc.cc consumes. Its text files are byte for byte the
JAX writer's on the same arguments; its pixels are within 1 grey level.
"""

from __future__ import annotations

import os

import numpy as np

from orbslam3_tpu_torch.datasets import imageio
from orbslam3_tpu_torch.datasets.render import BoxScene, excited_trajectory


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), w >= 0."""
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(R).as_quat()  # xyzw
    q = np.array([q[3], q[0], q[1], q[2]])
    return q if q[0] >= 0 else -q


CONFIG_TEMPLATE = """%YAML:1.0
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
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: {imu_rate}
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _cached_render(cache_root: str, out_dir: str, kwargs: dict) -> str:
    """Disk cache for written sequences, keyed by (arguments, the sources of
    this module, the renderer and the codec), so any change to them
    invalidates stale entries."""
    import hashlib
    import inspect
    import shutil
    import sys

    from orbslam3_tpu_torch.datasets import render
    src = "".join(inspect.getsource(m) for m in (sys.modules[__name__], render, imageio))
    key = hashlib.sha1((repr(sorted(kwargs.items())) + src).encode()).hexdigest()[:20]
    hit = os.path.join(cache_root, "torch-" + key)
    if not os.path.exists(os.path.join(hit, "config.yaml")):
        tmp = hit + f".tmp{os.getpid()}"
        saved = os.environ.pop("ORB_SYNTH_CACHE")
        try:
            write_synth_euroc(tmp, **kwargs)
        finally:
            os.environ["ORB_SYNTH_CACHE"] = saved
            if os.path.exists(tmp) and os.path.exists(hit):
                shutil.rmtree(tmp)  # a concurrent writer won the slot
        os.makedirs(cache_root, exist_ok=True)
        if not os.path.exists(hit):
            os.replace(tmp, hit)
    if os.path.abspath(hit) != os.path.abspath(out_dir):
        shutil.copytree(hit, out_dir, dirs_exist_ok=True)
    return out_dir


def write_synth_euroc(out_dir: str, n_frames: int = 60, width: int = 640,
                      height: int = 480, fps: float = 20.0,
                      imu_rate: float = 200.0, seed: int = 0,
                      fx: float = 458.0, fy: float = 458.0,
                      radius: float = 3.0, arc: float = 1.2,
                      n_features: int = 800,
                      imu_noise: bool = True,
                      excitation: float = 0.06,
                      rot_excitation: float = 0.0,
                      fisheye: bool = False,
                      kb8_dist: tuple = (0.05, 0.01, 0.002, 0.001),
                      stereo_baseline: float = 0.0,
                      pinhole_dist: tuple = (),
                      stereo_rot: float = 0.0,
                      look: str = 'center') -> str:
    """Render and write a sequence; returns `out_dir`.

    Body frame == camera frame (T_b_c1 = I). Timestamps start at 100 s to
    exercise ns-timestamp parsing. `fisheye` renders through a KB8 camera
    with `kb8_dist`, `pinhole_dist` through a rad-tan pinhole,
    `stereo_baseline` > 0 adds cam1 at that baseline along x, turned by
    `stereo_rot` rad about y.

    When the environment sets ORB_SYNTH_CACHE to a directory, finished
    sequences are kept there keyed by (arguments, sources) and repeat calls
    copy instead of re-rendering.
    """
    cache_root = os.environ.get("ORB_SYNTH_CACHE", "")
    if cache_root:
        kwargs = dict(
            n_frames=n_frames, width=width, height=height, fps=fps,
            imu_rate=imu_rate, seed=seed, fx=fx, fy=fy, radius=radius,
            arc=arc, n_features=n_features, imu_noise=imu_noise,
            excitation=excitation, rot_excitation=rot_excitation,
            fisheye=fisheye, kb8_dist=tuple(kb8_dist),
            stereo_baseline=stereo_baseline,
            pinhole_dist=tuple(pinhole_dist), stereo_rot=stereo_rot,
            look=look)
        return _cached_render(cache_root, out_dir, kwargs)
    cx, cy = width / 2.0, height / 2.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    scene = BoxScene.default(seed=seed)
    center = (scene.lo + scene.hi) / 2.0
    center = (float(center[0]), float(center[1]), float(center[2]) + 3.0)
    R_cw, t_cw, frame_idx, imu_t, imu_gyro, imu_acc = excited_trajectory(
        n_frames, fps, imu_rate, center, radius, arc,
        excitation=excitation, rot_excitation=rot_excitation, seed=seed,
        look=look)
    t0 = 100.0
    frame_ts = t0 + np.arange(n_frames) / fps

    cam_dir = os.path.join(out_dir, "mav0", "cam0", "data")
    imu_dir = os.path.join(out_dir, "mav0", "imu0")
    gt_dir = os.path.join(out_dir, "mav0", "state_groundtruth_estimate0")
    for d in (cam_dir, imu_dir, gt_dir):
        os.makedirs(d, exist_ok=True)

    cam1_dir = os.path.join(out_dir, "mav0", "cam1", "data")
    if stereo_baseline > 0:
        os.makedirs(cam1_dir, exist_ok=True)
    render_cam = None
    if fisheye:
        from orbslam3_tpu_torch.core.camera import Camera
        render_cam = Camera.kb8(fx, fy, cx, cy, *kb8_dist, width=width, height=height,
                                device="cpu")
    elif pinhole_dist:
        from orbslam3_tpu_torch.core.camera import Camera
        render_cam = Camera.pinhole(fx, fy, cx, cy, dist=tuple(pinhole_dist),
                                    width=width, height=height, device="cpu")
    # optional left->right rotation (unrectified pinhole pairs): T_c1_c2 =
    # [R12 | t12] is the pose of cam2 in cam1 (x_c1 = R12 x_c2 + t12)
    if stereo_rot != 0.0:
        from scipy.spatial.transform import Rotation
        R12 = Rotation.from_rotvec([0.0, stereo_rot, 0.0]).as_matrix()
    else:
        R12 = np.eye(3)
    t12 = np.array([stereo_baseline, 0.0, 0.0])
    lines = ["#timestamp [ns],filename"]
    for i in range(n_frames):
        img = scene.render(K, R_cw[i], t_cw[i], width, height,
                           seed=seed * 1000 + i, camera=render_cam)
        ns = int(round(frame_ts[i] * 1e9))
        imageio.imwrite(os.path.join(cam_dir, f"{ns}.png"), img)
        lines.append(f"{ns},{ns}.png")
        if stereo_baseline > 0:
            # right view from T_c1_c2: x_c2 = R12^T (x_c1 - t12)
            R_r = R12.T @ R_cw[i]
            t_r = R12.T @ (t_cw[i] - t12)
            img_r = scene.render(K, R_r, t_r, width, height,
                                 seed=seed * 1000 + i + 500000, camera=render_cam)
            imageio.imwrite(os.path.join(cam1_dir, f"{ns}.png"), img_r)
    with open(os.path.join(out_dir, "mav0", "cam0", "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    if stereo_baseline > 0:
        with open(os.path.join(out_dir, "mav0", "cam1", "data.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")

    # IMU: body == camera; midpoint samples for [imu_t[k], imu_t[k+1]]
    # written at the interval END (what `preintegrate` integrates with)
    rng_imu = np.random.default_rng(seed + 5)
    gyr_w = imu_gyro + (rng_imu.normal(0, 2e-4, imu_gyro.shape) if imu_noise else 0.0)
    acc_w = imu_acc + (rng_imu.normal(0, 2e-3, imu_acc.shape) if imu_noise else 0.0)
    rows = ["#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,"
            "a_RS_S_x,a_RS_S_y,a_RS_S_z"]
    # one leading sample just before the first frame
    ns = int(round((t0 - 0.005) * 1e9))
    rows.append(",".join([str(ns)] + [f"{x:.9f}" for x in gyr_w[0]]
                         + [f"{x:.9f}" for x in acc_w[0]]))
    for k in range(len(gyr_w)):
        ns = int(round((t0 + imu_t[k + 1]) * 1e9))
        rows.append(",".join([str(ns)] + [f"{x:.9f}" for x in gyr_w[k]]
                             + [f"{x:.9f}" for x in acc_w[k]]))
    with open(os.path.join(imu_dir, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")

    # GT: body pose in world
    g_rows = ["#timestamp,p_RS_R_x,p_RS_R_y,p_RS_R_z,q_RS_w,q_RS_x,q_RS_y,q_RS_z"]
    for i in range(n_frames):
        R_wb = R_cw[i].T
        p = -R_wb @ t_cw[i]
        q = quat_wxyz(R_wb)
        ns = int(round(frame_ts[i] * 1e9))
        g_rows.append(",".join([str(ns)] + [f"{x:.9f}" for x in p]
                               + [f"{x:.9f}" for x in q]))
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("\n".join(g_rows) + "\n")

    cfg_text = CONFIG_TEMPLATE.format(fx=fx, fy=fy, cx=cx, cy=cy, width=width,
                                      height=height, fps=fps, imu_rate=imu_rate,
                                      n_features=n_features)
    if fisheye:
        k1, k2, k3, k4 = kb8_dist
        cfg_text = cfg_text.replace('Camera.type: "PinHole"',
                                    'Camera.type: "KannalaBrandt8"')
        cfg_text = cfg_text.replace(
            "Camera1.k1: 0.0\nCamera1.k2: 0.0\nCamera1.p1: 0.0\nCamera1.p2: 0.0",
            f"Camera1.k1: {k1}\nCamera1.k2: {k2}\nCamera1.k3: {k3}\nCamera1.k4: {k4}")
    elif pinhole_dist:
        pd = (tuple(pinhole_dist) + (0.0,) * 5)[:5]
        cfg_text = cfg_text.replace(
            "Camera1.k1: 0.0\nCamera1.k2: 0.0\nCamera1.p1: 0.0\nCamera1.p2: 0.0",
            f"Camera1.k1: {pd[0]}\nCamera1.k2: {pd[1]}\n"
            f"Camera1.p1: {pd[2]}\nCamera1.p2: {pd[3]}\n"
            f"Camera1.k3: {pd[4]}")
    if stereo_baseline > 0:
        b = stereo_baseline
        unrectified = bool(pinhole_dist) or stereo_rot != 0.0
        cfg_text += (f"Camera2.fx: {fx}\nCamera2.fy: {fy}\n"
                     f"Camera2.cx: {cx}\nCamera2.cy: {cy}\n")
        if fisheye:
            k1, k2, k3, k4 = kb8_dist
            cfg_text += (f"Camera2.k1: {k1}\nCamera2.k2: {k2}\n"
                         f"Camera2.k3: {k3}\nCamera2.k4: {k4}\n"
                         "Stereo.ThDepth: 35.0\n")
        elif unrectified:
            # raw pinhole pair: per-camera distortion, no Camera.bf; the
            # settings derive the geometry by rectification
            pd = (tuple(pinhole_dist) + (0.0,) * 5)[:5]
            cfg_text += (f"Camera2.k1: {pd[0]}\nCamera2.k2: {pd[1]}\n"
                         f"Camera2.p1: {pd[2]}\nCamera2.p2: {pd[3]}\n"
                         f"Camera2.k3: {pd[4]}\n"
                         "Stereo.ThDepth: 35.0\n")
        else:
            cfg_text += f"Camera.bf: {b * fx}\nStereo.ThDepth: 35.0\n"
        rows = np.concatenate([np.concatenate([R12, t12[:, None]], 1),
                               [[0.0, 0.0, 0.0, 1.0]]], 0)
        flat = ",\n          ".join(", ".join(f"{x:.12f}" for x in r) for r in rows)
        cfg_text += ("Stereo.T_c1_c2: !!opencv-matrix\n"
                     "   rows: 4\n   cols: 4\n   dt: f\n"
                     f"   data: [{flat}]\n")
    with open(os.path.join(out_dir, "config.yaml"), "w") as f:
        f.write(cfg_text)
    return out_dir
