"""Typed settings from the reference's YAML configs.

Port of `orbslam3_tpu/config.py`: reads ORB-SLAM3's OpenCV-FileStorage
YAML, both the new format (``File.version: "1.0"``, `Camera1.fx`, ...) and
the legacy flat one (`Camera.fx`, ...), so the reference's dataset configs
(EuRoC, TUM, TUM-VI, KITTI) load unchanged, and turns it into the port's
`Camera`, `RectifyMaps`, `ImuCalib` and `SystemConfig`.

The reference parses the file with PyYAML, which the machine with the card
does not have; `load_opencv_yaml` parses the subset those configs use
instead: the `%YAML:1.0` directive, comments, ``key: scalar`` lines with
quoted or plain scalars, and ``!!opencv-matrix`` blocks whose
``data: [...]`` may span lines. Anything else raises.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from orbslam3_tpu_torch import device as device_policy

_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_KEY = re.compile(r"([A-Za-z_][\w.\-]*)\s*:(.*)$")


def _strip_comment(line: str) -> str:
    """The line without a `#` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _scalar(text: str):
    """A plain or quoted scalar: quoted -> str; integer and float literals
    (with or without a dot, as OpenCV writes them) -> int / float;
    true/false -> bool; anything else -> str."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if _INT.match(t):
        return int(t)
    if _FLOAT.match(t):
        return float(t)
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    return t


def load_opencv_yaml(text: str) -> dict:
    """Parse the text of an OpenCV-FileStorage YAML into a flat
    {key: value} dict; an ``!!opencv-matrix`` becomes a float64 array of
    shape (rows, cols)."""
    lines = [_strip_comment(raw).rstrip() for raw in text.splitlines()]
    out: dict = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.startswith("%YAML") or line.strip() == "---":
            continue
        if line[0].isspace():
            raise ValueError(f"load_opencv_yaml: unexpected indented line {line!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"load_opencv_yaml: cannot parse {line!r}")
        key, rest = m.group(1), m.group(2).strip()
        if rest.startswith("!!opencv-matrix") or rest.startswith("!opencv-matrix"):
            fields, buf = {}, None
            while i < len(lines) and (not lines[i].strip() or lines[i][0].isspace()):
                sub = lines[i].strip()
                i += 1
                if not sub:
                    continue
                if buf is not None:
                    buf += " " + sub
                else:
                    fm = _KEY.match(sub)
                    if fm is None:
                        raise ValueError(f"load_opencv_yaml: cannot parse {sub!r} in {key}")
                    name, val = fm.group(1), fm.group(2).strip()
                    if name == "data":
                        buf = val
                    else:
                        fields[name] = _scalar(val)
                if buf is not None and "]" in buf:
                    fields["data"] = buf
                    buf = None
            data = fields.get("data", "")
            if not (data.startswith("[") and data.endswith("]")):
                raise ValueError(f"load_opencv_yaml: {key} has no data: [...] list")
            vals = [float(v) for v in data[1:-1].replace(",", " ").split()]
            out[key] = np.asarray(vals, np.float64).reshape(int(fields["rows"]),
                                                            int(fields["cols"]))
        elif rest.startswith(("[", "{", "|", ">", "!")) or rest == "":
            raise ValueError(f"load_opencv_yaml: unsupported value for {key}: {rest!r}")
        else:
            out[key] = _scalar(rest)
    return out


@dataclass
class ImuSettings:
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    gyro_walk: float = 1.9e-5
    acc_walk: float = 3.0e-3
    frequency: float = 200.0
    T_b_c1: np.ndarray = field(default_factory=lambda: np.eye(4))
    insert_kfs_when_lost: bool = True


@dataclass
class Settings:
    """Typed view of a reference config file."""

    # camera
    camera_type: str = 'PinHole'      # PinHole | KannalaBrandt8 | Rectified
    fx: float = 458.0
    fy: float = 458.0
    cx: float = 320.0
    cy: float = 240.0
    dist: tuple = (0.0, 0.0, 0.0, 0.0)   # k1 k2 p1 p2 [k3], or KB8 k1..k4
    width: int = 752
    height: int = 480
    fps: float = 30.0
    rgb: bool = True
    new_width: int = -1               # Camera.newWidth resize target
    new_height: int = -1
    # stereo
    stereo: bool = False
    bf: float = 0.0                   # baseline * fx (Camera.bf)
    th_depth: float = 35.0            # close/far point threshold
    T_c1_c2: np.ndarray | None = None  # stereo extrinsics (Stereo.T_c1_c2)
    # right camera of a non-rectified pair; None -> the left's
    fx2: float | None = None
    fy2: float | None = None
    cx2: float | None = None
    cy2: float | None = None
    dist2: tuple | None = None
    # rgbd
    rgbd: bool = False
    depth_map_factor: float = 1.0
    # imu
    inertial: bool = False
    imu: ImuSettings = field(default_factory=ImuSettings)
    # orb extractor
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # system
    load_atlas_from: str = ''
    save_atlas_to: str = ''
    th_far_points: float = 0.0
    loop_closing: bool = True

    # ------------------------------------------------------------- factory
    @staticmethod
    def from_yaml(path: str, sensor: str = 'monocular') -> 'Settings':
        """Settings from a config file; `sensor` names the sensor as the
        reference's examples do ('stereo', 'rgbd', 'imu_stereo', ...)."""
        with open(path) as f:
            return Settings.from_text(f.read(), sensor)

    @staticmethod
    def from_text(text: str, sensor: str = 'monocular') -> 'Settings':
        """Settings from the text of a config file."""
        d = load_opencv_yaml(text)
        s = Settings()
        low = sensor.lower()
        s.inertial = 'imu' in low or 'inertial' in low
        s.stereo = 'stereo' in low
        s.rgbd = 'rgbd' in low or 'rgb-d' in low
        new_format = str(d.get('File.version', '')) == '1.0'
        cam = 'Camera1' if new_format else 'Camera'
        get = d.get

        def radtan(prefix):
            return tuple(float(get(f'{prefix}.{k}', 0.0))
                         for k in ('k1', 'k2', 'p1', 'p2', 'k3'))

        s.camera_type = str(get('Camera.type', 'PinHole'))
        s.fx = float(get(f'{cam}.fx', s.fx))
        s.fy = float(get(f'{cam}.fy', s.fy))
        s.cx = float(get(f'{cam}.cx', s.cx))
        s.cy = float(get(f'{cam}.cy', s.cy))
        if s.camera_type == 'KannalaBrandt8':
            s.dist = tuple(float(get(f'{cam}.k{i}', 0.0)) for i in (1, 2, 3, 4))
        else:
            s.dist = radtan(cam)
        s.width = int(get('Camera.width', s.width))
        s.height = int(get('Camera.height', s.height))
        s.fps = float(get('Camera.fps', get('Camera.fs', s.fps)))
        s.rgb = bool(int(get('Camera.RGB', 1)))
        s.new_width = int(get('Camera.newWidth', -1))
        s.new_height = int(get('Camera.newHeight', -1))
        s.bf = float(get('Camera.bf', 0.0))
        s.th_depth = float(get('Stereo.ThDepth', get('Camera.ThDepth', get('ThDepth', 35.0))))
        if get('Stereo.T_c1_c2') is not None:
            s.T_c1_c2 = np.asarray(get('Stereo.T_c1_c2'), np.float64)
        # the right camera keeps its own calibration (Settings::readCamera2)
        if get('Camera2.fx') is not None:
            s.fx2 = float(get('Camera2.fx'))
            s.fy2 = float(get('Camera2.fy', s.fx2))
            s.cx2 = float(get('Camera2.cx', 0.0))
            s.cy2 = float(get('Camera2.cy', 0.0))
            if s.camera_type == 'KannalaBrandt8':
                s.dist2 = tuple(float(get(f'Camera2.k{i}', 0.0)) for i in (1, 2, 3, 4))
            else:
                s.dist2 = radtan('Camera2')
        s.depth_map_factor = float(get('RGBD.DepthMapFactor', get('DepthMapFactor', 1.0)))
        imu = ImuSettings(
            noise_gyro=float(get('IMU.NoiseGyro', 1.7e-4)),
            noise_acc=float(get('IMU.NoiseAcc', 2e-3)),
            gyro_walk=float(get('IMU.GyroWalk', 1.9e-5)),
            acc_walk=float(get('IMU.AccWalk', 3e-3)),
            frequency=float(get('IMU.Frequency', 200.0)),
            insert_kfs_when_lost=bool(int(get('IMU.InsertKFsWhenLost', 1))),
        )
        Tbc = get('IMU.T_b_c1', get('Tbc'))
        if Tbc is not None:
            imu.T_b_c1 = np.asarray(Tbc, np.float64).reshape(4, 4)
        s.imu = imu
        s.n_features = int(get('ORBextractor.nFeatures', s.n_features))
        s.scale_factor = float(get('ORBextractor.scaleFactor', s.scale_factor))
        s.n_levels = int(get('ORBextractor.nLevels', s.n_levels))
        s.ini_th_fast = int(get('ORBextractor.iniThFAST', s.ini_th_fast))
        s.min_th_fast = int(get('ORBextractor.minThFAST', s.min_th_fast))
        s.load_atlas_from = str(get('System.LoadAtlasFromFile', ''))
        s.save_atlas_to = str(get('System.SaveAtlasToFile', ''))
        s.th_far_points = float(get('thFarPoints', 0.0))
        lc = get('loopClosing')
        if lc is not None:
            s.loop_closing = bool(int(lc))
        return s

    # ------------------------------------------------------------ adapters
    def rectification(self, device=None):
        """The rectification maps of a raw pinhole stereo pair
        (`Settings::precomputeRectificationMaps`) on `device` (the card
        unless ``device="cpu"``), or None when the config is not one."""
        rect = self._rectification()
        return None if rect is None else rect.to(device_policy.resolve(device))

    def _rectification(self):
        """The rectification, solved once and kept with its maps on the
        host; None for a pair that needs none (an identity-rotation,
        distortion-free pair is rectified already) or a config that is not
        a raw pinhole pair."""
        if not hasattr(self, '_rect'):
            rect = None
            needs_rect = False
            if self.T_c1_c2 is not None:
                distorted = (any(abs(k) > 1e-12 for k in self.dist)
                             or any(abs(k) > 1e-12 for k in (self.dist2 or ())))
                rotated = np.abs(self.T_c1_c2[:3, :3] - np.eye(3)).max() > 1e-9
                needs_rect = distorted or rotated
            if (self.stereo and self.camera_type == 'PinHole'
                    and needs_rect and self.fx2 is not None):
                from orbslam3_tpu_torch.vision.rectify import RectifyMaps
                K1 = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1.0]])
                K2 = np.array([[self.fx2, 0, self.cx2], [0, self.fy2, self.cy2],
                               [0, 0, 1.0]])
                # T_c1_c2 maps camera-2 coords into camera 1; stereo_rectify
                # takes left -> right (x_r = R12 x_l + t12), its inverse
                R12 = self.T_c1_c2[:3, :3].T
                t12 = -R12 @ self.T_c1_c2[:3, 3]
                rect = RectifyMaps(K1, self.dist, K2, self.dist2 or (0.,) * 5,
                                   (self.width, self.height), R12, t12, device="cpu")
            self._rect = rect
        return self._rect

    def camera(self, device=None):
        """The camera model (resized if asked). For a raw pinhole stereo
        pair it is the rectified camera, the ideal pinhole both remapped
        images obey."""
        from orbslam3_tpu_torch.core.camera import Camera
        rect = self.rectification(device)
        if rect is not None:
            K = rect.K_new
            return Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                                  width=self.width, height=self.height, device=device)
        fx, fy, cx, cy = self.fx, self.fy, self.cx, self.cy
        w, h = self.width, self.height
        if self.new_width > 0 and self.new_height > 0:
            sx = self.new_width / w
            sy = self.new_height / h
            fx, cx, fy, cy = fx * sx, cx * sx, fy * sy, cy * sy
            w, h = self.new_width, self.new_height
        if self.camera_type == 'KannalaBrandt8':
            return Camera.kb8(fx, fy, cx, cy, *self.dist[:4], width=w, height=h,
                              device=device)
        dist = self.dist if self.camera_type == 'PinHole' else (0.,) * 5
        return Camera.pinhole(fx, fy, cx, cy, dist=tuple(dist), width=w, height=h,
                              device=device)

    def camera2(self, device=None):
        """The right camera of a non-rectified pair (the left's when
        Camera2.* is absent)."""
        from orbslam3_tpu_torch.core.camera import Camera
        if self.fx2 is None:
            return self.camera(device)
        if self.camera_type == 'KannalaBrandt8':
            return Camera.kb8(self.fx2, self.fy2, self.cx2, self.cy2, *self.dist2[:4],
                              width=self.width, height=self.height, device=device)
        return Camera.pinhole(self.fx2, self.fy2, self.cx2, self.cy2,
                              dist=tuple(self.dist2 or (0.,) * 5),
                              width=self.width, height=self.height, device=device)

    def imu_calib(self):
        """`ImuCalib` from the IMU block (Settings::readIMU); with
        rectification, camera 1's frame is turned by R1, which folds into
        the body<->camera extrinsic: Tbc' = Tbc (R1, 0)^-1."""
        from orbslam3_tpu_torch.imu.preintegration import ImuCalib
        Tbc = self.imu.T_b_c1
        rect = self._rectification()
        if rect is not None:
            Tr = np.eye(4)
            Tr[:3, :3] = rect.R1
            Tbc = Tbc @ np.linalg.inv(Tr)
        return ImuCalib.create(Tbc=Tbc, noise_gyro=self.imu.noise_gyro,
                               noise_acc=self.imu.noise_acc, walk_gyro=self.imu.gyro_walk,
                               walk_acc=self.imu.acc_walk, freq=self.imu.frequency)

    def system_config(self, map_cfg=None, device=None):
        """`SystemConfig` for the sensor: bf from the rectified geometry (or
        baseline * fx of a rectified pair without Camera.bf), the fisheye
        pair's triangulation path for KB8 stereo, and the reference's
        keyframe ratio of 0.75 for every sensor but plain monocular."""
        from orbslam3_tpu_torch.engine.system import Sensor, SystemConfig
        from orbslam3_tpu_torch.engine.tracking import TrackerConfig
        from orbslam3_tpu_torch.slam_map.map_state import MapConfig
        if self.stereo:
            sensor = Sensor.IMU_STEREO if self.inertial else Sensor.STEREO
        elif self.rgbd:
            sensor = Sensor.IMU_RGBD if self.inertial else Sensor.RGBD
        else:
            sensor = Sensor.IMU_MONOCULAR if self.inertial else Sensor.MONOCULAR
        mc = map_cfg or MapConfig(features_per_frame=self.n_features)
        rect = self.rectification(device)
        bf = self.bf
        if rect is not None:
            bf = float(rect.bf)  # Settings.cc: bf from the rectified geometry
        elif bf <= 0 and self.stereo and self.T_c1_c2 is not None:
            fx = self.fx
            if self.new_width > 0:
                fx = fx * self.new_width / self.width
            bf = float(np.linalg.norm(self.T_c1_c2[:3, 3])) * fx
        tracker = TrackerConfig(n_features=self.n_features, bf=bf, th_depth=self.th_depth,
                                rectify=rect, n_levels=self.n_levels,
                                scale_factor=self.scale_factor,
                                ini_th_fast=float(self.ini_th_fast),
                                min_th_fast=float(self.min_th_fast),
                                th_far_points=self.th_far_points)
        if (self.stereo and self.camera_type == 'KannalaBrandt8'
                and self.T_c1_c2 is not None):
            # a non-rectified fisheye pair: two-view triangulation instead
            # of the row search, and no virtual right coordinates
            R12 = self.T_c1_c2[:3, :3].astype(np.float32)
            t12 = self.T_c1_c2[:3, 3].astype(np.float32)
            tracker.fisheye_stereo = True
            tracker.camera2 = self.camera2(device)
            tracker.stereo_R_rl = R12.T
            tracker.stereo_t_rl = (-R12.T @ t12).astype(np.float32)
            tracker.baseline_m = float(np.linalg.norm(t12))
            tracker.bf = 0.0
        if self.stereo or self.inertial or self.rgbd:
            tracker.kf_ref_ratio = 0.75  # thRefRatio: 0.9 only for monocular
        return SystemConfig(sensor=sensor, map=mc, tracker=tracker,
                            imu_calib=self.imu_calib() if self.inertial else None)

