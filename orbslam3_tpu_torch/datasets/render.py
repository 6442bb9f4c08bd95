"""Textured-box scene renderer: geometrically exact synthetic images.

Port of `orbslam3_tpu/datasets/render.py`: renders the interior of an
axis-aligned textured box along a known camera trajectory by per-pixel
ray/plane intersection and bilinear texture sampling, so the full image
pipeline (pyramid -> FAST -> BRIEF -> matching -> BA) runs on data with
exact ground truth.

The reference calls OpenCV (`cv2.resize` bicubic and nearest, `cv2.remap`
bilinear); here those are numpy functions written to OpenCV's rules
(half-pixel centres, a = -0.75 cubic, replicated borders; floor-mapped
nearest; float bilinear remap rounded to uint8), so the port renders
without OpenCV. The images differ from the reference's by
at most 1 grey level (`tests/test_torch_render.py` measures it).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def _cubic_weights(x: np.ndarray) -> np.ndarray:
    """(n,) fractions -> (n, 4) OpenCV bicubic weights (a = -0.75)."""
    A = -0.75
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    return np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=-1).astype(np.float32)


def _cubic_axis(n_src: int, n_dst: int):
    fx = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    sx = np.floor(fx)
    idx = np.clip(sx[:, None].astype(np.int64) + np.arange(-1, 3), 0, n_src - 1)
    return idx, _cubic_weights((fx - sx).astype(np.float32))


def resize_cubic(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)` of a
    float32 image: separable a = -0.75 cubic, centre-aligned, borders
    replicated."""
    iy, wy = _cubic_axis(img.shape[0], size)
    ix, wx = _cubic_axis(img.shape[1], size)
    rows = np.einsum("ykx,yk->yx", img[iy], wy)            # (size, w_src)
    return np.einsum("ysk,sk->ys", rows[:, ix], wx).astype(np.float32)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """`cv2.resize(..., interpolation=cv2.INTER_NEAREST)`: the source pixel
    floor(dst * src / dst_size)."""
    iy = np.minimum(np.floor(np.arange(size) * (img.shape[0] / size)).astype(np.int64),
                    img.shape[0] - 1)
    ix = np.minimum(np.floor(np.arange(size) * (img.shape[1] / size)).astype(np.int64),
                    img.shape[1] - 1)
    return img[iy[:, None], ix[None, :]]


def remap_linear(tex: np.ndarray, mx: np.ndarray, my: np.ndarray) -> np.ndarray:
    """`cv2.remap(tex, mx, my, cv2.INTER_LINEAR)` of a uint8 texture at
    in-range float32 maps: float bilinear interpolation rounded to uint8."""
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    fx = (mx - x0).astype(np.float32)
    fy = (my - y0).astype(np.float32)
    h, w = tex.shape
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    t = tex.astype(np.float32)
    top = t[y0, x0] * (1 - fx) + t[y0, x1] * fx
    bot = t[y1, x0] * (1 - fx) + t[y1, x1] * fx
    return np.clip(np.rint(top * (1 - fy) + bot * fy), 0, 255).astype(np.uint8)


def make_texture(size: int = 1024, seed: int = 0, n_blobs: int = 350,
                 family: str = "blobs"):
    """High-contrast corner-rich texture; `family` selects a visually and
    statistically distinct generator so vocabulary training can hold out a
    whole appearance family (VERDICT r4 missing #3: P/R was only validated
    on the same texture family that trained the tree):
      * "blobs"   — multi-scale smoothed noise + random-interior squares
                    (the original; every shipped golden uses this);
      * "cells"   — Voronoi-like polygonal cells with per-cell albedo and
                    dark borders (indoor wall/panel statistics);
      * "stripes" — superposed rotated square-wave gratings + speckle
                    (fabric/woodgrain statistics, strong oriented edges)."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for scale, amp in ((8, 40.0), (32, 30.0), (128, 25.0)):
        small = rng.uniform(-1, 1, (scale, scale)).astype(np.float32)
        tex += amp * resize_cubic(small, size)
    tex += 128.0
    if family == "blobs":
        # each blob gets its OWN random interior pattern: identical flat
        # squares would create repeated-texture descriptor ambiguity far
        # beyond real imagery and systematically corrupt data association
        for _ in range(n_blobs):
            s = int(rng.integers(8, 28))
            x = int(rng.integers(0, size - s))
            y = int(rng.integers(0, size - s))
            cells = int(rng.integers(2, 5))
            patch = rng.uniform(0, 255, (cells, cells)).astype(np.float32)
            patch = resize_nearest(patch, s)
            tex[y:y + s, x:x + s] = (0.3 * tex[y:y + s, x:x + s]
                                     + 0.7 * patch)
    elif family == "cells":
        n_sites = 220
        albedo = rng.uniform(40, 230, n_sites).astype(np.float32)
        # nearest/second-nearest fields at quarter resolution (exact Voronoi
        # at full res is O(size^2 * sites)); NEAREST upsampling keeps the
        # cell edges crisp, which is what FAST needs
        lo_res = max(size // 4, 128)
        sites = rng.uniform(0, lo_res, (n_sites, 2)).astype(np.float32)
        yy, xx = np.meshgrid(np.arange(lo_res, dtype=np.float32),
                             np.arange(lo_res, dtype=np.float32),
                             indexing="ij")
        p = np.stack([xx, yy], -1)
        d = np.linalg.norm(p[:, :, None, :] - sites[None, None], axis=-1)
        part = np.partition(d, 1, axis=-1)
        cell = d.argmin(-1).astype(np.int32)
        border = part[..., 1] - part[..., 0]
        cell = resize_nearest(cell, size)
        border = resize_nearest(border, size)
        tex = 0.35 * tex + 0.65 * albedo[cell]
        tex[border < 0.7] *= 0.25          # dark cell borders -> corners
    elif family == "stripes":
        yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                             np.arange(size, dtype=np.float32),
                             indexing="ij")
        for _ in range(4):
            th = rng.uniform(0, np.pi)
            period = rng.uniform(18, 60)
            phase = rng.uniform(0, 2 * np.pi)
            wave = np.sign(np.sin(
                2 * np.pi * (xx * np.cos(th) + yy * np.sin(th)) / period
                + phase))
            tex += rng.uniform(18, 32) * wave
        speck = (rng.uniform(0, 1, (size, size)) < 0.02)
        tex[speck] = rng.uniform(0, 255, int(speck.sum()))
    else:
        raise ValueError(f"unknown texture family {family!r}")
    return np.clip(tex, 0, 255).astype(np.uint8)


def _camera_rays(camera, width: int, height: int) -> np.ndarray:
    """The camera-frame ray of every pixel centre through `camera`'s model,
    (height, width, 3) float64, read-only."""
    camera = camera.to("cpu")
    return _rays(camera.kind, tuple(camera.params.tolist()), width, height)


@functools.lru_cache(maxsize=4)
def _rays(kind: str, params: tuple, width: int, height: int) -> np.ndarray:
    """`_camera_rays`, kept per camera and size: a sequence renders every
    frame through the same rays, and a KB8 unprojection (Newton on the
    theta polynomial) costs three times the rest of a frame."""
    from orbslam3_tpu_torch.core.camera import Camera
    camera = Camera(kind, torch.tensor(params, dtype=torch.float32), width, height)
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    uv = np.stack([u.reshape(-1), v.reshape(-1)], -1)
    # undistort first so distorted-pinhole (radtan) cameras render exactly;
    # for KB8 undistort_points is identity and unproject holds the model
    uvq = camera.undistort_points(torch.as_tensor(uv, dtype=torch.float32))
    d_c = camera.unproject(uvq).numpy().astype(np.float64).reshape(height, width, 3)
    d_c.setflags(write=False)
    return d_c


@dataclasses.dataclass
class BoxScene:
    """Axis-aligned box interior: 6 textured faces.

    Face k is the plane axis[k] = value[k]; texture coordinates are the two
    remaining axes scaled to the face extent.
    """

    lo: np.ndarray            # (3,) box min corner
    hi: np.ndarray            # (3,) box max corner
    textures: list            # 6 uint8 (S,S) textures, faces [x-,x+,y-,y+,z-,z+]

    @staticmethod
    def default(seed: int = 0, box=((-8, 8), (-5, 5), (-4, 14)),
                tex_size: int = 1024, family: str = "blobs") -> "BoxScene":
        lo = np.array([b[0] for b in box], np.float64)
        hi = np.array([b[1] for b in box], np.float64)
        textures = [make_texture(tex_size, seed=seed * 13 + f, family=family)
                    for f in range(6)]
        return BoxScene(lo, hi, textures)

    def render(self, K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
               width: int, height: int, noise_std: float = 1.5,
               seed: int = 0, camera=None, return_depth: bool = False):
        """Grayscale uint8 (height, width) view from camera (R_cw, t_cw).

        With `camera` (the port's core.camera.Camera, e.g. KB8 fisheye),
        rays come from the camera model's unprojection instead of the
        pinhole K — renders geometrically exact distorted imagery.

        With `return_depth` also returns the (height, width) float32
        camera-z depth map (meters, 0 where no surface) — for pinhole rays
        (z-normalized d_c) the ray parameter IS the camera depth, giving
        exact registered RGB-D imagery for the TUM-RGBD pipeline."""
        rng = np.random.default_rng(seed)
        # pixel rays in world frame; pixel centers at integer coordinates
        # (OpenCV convention, matching the extractor's keypoint coordinates)
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        if camera is not None:
            d_c = _camera_rays(camera, width, height)
        else:
            d_c = np.stack([(u - K[0, 2]) / K[0, 0],
                            (v - K[1, 2]) / K[1, 1],
                            np.ones_like(u)], axis=-1)      # (H,W,3)
        R_wc = R_cw.T
        o = -R_wc @ t_cw                                     # camera center
        d_w = d_c @ R_wc.T                                   # (H,W,3)

        best_t = np.full((height, width), np.inf)
        out = np.zeros((height, width), np.float32)
        faces = [(a, val, f) for f, (a, val) in enumerate(
            [(0, self.lo[0]), (0, self.hi[0]),
             (1, self.lo[1]), (1, self.hi[1]),
             (2, self.lo[2]), (2, self.hi[2])])]
        for axis, val, f in faces:
            denom = d_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (val - o[axis]) / denom
            hitp = o[None, None, :] + t[..., None] * d_w     # (H,W,3)
            a1, a2 = [a for a in range(3) if a != axis]
            eps = 1e-6
            ok = (np.abs(denom) > 1e-12) & (t > 1e-3) & (t < best_t)
            ok &= (hitp[..., a1] >= self.lo[a1] - eps)
            ok &= (hitp[..., a1] <= self.hi[a1] + eps)
            ok &= (hitp[..., a2] >= self.lo[a2] - eps)
            ok &= (hitp[..., a2] <= self.hi[a2] + eps)
            if not ok.any():
                continue
            tex = self.textures[f]
            S = tex.shape[0]
            tu = (hitp[..., a1] - self.lo[a1]) / (self.hi[a1] - self.lo[a1])
            tv = (hitp[..., a2] - self.lo[a2]) / (self.hi[a2] - self.lo[a2])
            mx = np.clip(tu * (S - 1), 0, S - 1.001).astype(np.float32)
            my = np.clip(tv * (S - 1), 0, S - 1.001).astype(np.float32)
            samp = remap_linear(tex, mx, my)
            out = np.where(ok, samp.astype(np.float32), out)
            best_t = np.where(ok, t, best_t)
        if noise_std > 0:
            out = out + rng.normal(0, noise_std, out.shape)
        img = np.clip(out, 0, 255).astype(np.uint8)
        if return_depth:
            z = d_c[..., 2]
            depth = np.where(np.isfinite(best_t), best_t * z, 0.0)
            return img, depth.astype(np.float32)
        return img


def _K(intrinsics) -> np.ndarray:
    fx, fy, cx, cy = intrinsics
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def _render_camera(intrinsics, dist, width: int, height: int):
    """The renderer's camera: None (rays through K) for an ideal pinhole,
    else a rad-tan pinhole, so the raw image carries the distortion."""
    if not any(abs(float(k)) > 0.0 for k in dist):
        return None
    from orbslam3_tpu_torch.core.camera import Camera
    return Camera.pinhole(*intrinsics, dist=tuple(dist), width=width, height=height,
                          device="cpu")


def stereo_extrinsics(baseline: float, rot: float = 0.0) -> np.ndarray:
    """T_c1_c2 (4,4), the pose of the right camera in the left (x_c1 =
    R12 x_c2 + t12), as the EuRoC writer builds it: `baseline` m along x
    and `rot` rad about y (its `stereo_rot`)."""
    from scipy.spatial.transform import Rotation
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec([0.0, rot, 0.0]).as_matrix()
    T[0, 3] = baseline
    return T


def _render_views(scene, R_cw, t_cw, width, height, intrinsics, dist, seeds,
                  right=None, T_c1_c2=None):
    """The left views (F, H, W) uint8 at `seeds`, and with `T_c1_c2` the
    right views through the right camera `right` = (intrinsics, dist) at
    seeds + 500000, the right pose x_c2 = R12^T (x_c1 - t12) (None
    without)."""
    cam_l = _render_camera(intrinsics, dist, width, height)
    left = np.stack([scene.render(_K(intrinsics), R_cw[i], t_cw[i], width, height,
                                  seed=int(seeds[i]), camera=cam_l)
                     for i in range(len(R_cw))])
    if T_c1_c2 is None:
        return left, None
    intr_r, dist_r = right if right is not None else (intrinsics, dist)
    cam_r = _render_camera(intr_r, dist_r, width, height)
    R12, t12 = np.asarray(T_c1_c2)[:3, :3], np.asarray(T_c1_c2)[:3, 3]
    right_views = np.stack([
        scene.render(_K(intr_r), R12.T @ R_cw[i], R12.T @ (t_cw[i] - t12), width,
                     height, seed=int(seeds[i]) + 500000, camera=cam_r)
        for i in range(len(R_cw))])
    return left, right_views


def orbit_sequence(n_frames: int = 40, width: int = 752, height: int = 480,
                   intrinsics=(458.654, 457.296, 367.215, 248.375),
                   seed: int = 7, radius: float = 2.0, center=(4.0, 2.0, 9.0),
                   arc: float = 1.0, fps: float = 20.0):
    """A monocular sequence inside `BoxScene.default(seed)`: the camera
    orbits `center` at `radius` over `arc` radians (0.026 rad a frame at
    the defaults), looking at it. The default view holds two walls and the
    floor's edge: the far wall alone is a plane, on which two-view
    initialization finds no clear motion. Returns (images (n, h, w) uint8,
    R_cw (n,3,3), t_cw (n,3), timestamps (n,))."""
    from orbslam3_tpu_torch.utils.synth import orbit_trajectory
    scene = BoxScene.default(seed=seed)
    R, t = orbit_trajectory(n_frames=n_frames, radius=radius, center=center, arc=arc)
    imgs, _ = _render_views(scene, R, t, width, height, intrinsics, (), np.arange(n_frames))
    return imgs, R, t, np.arange(n_frames) / fps


def orbit_views(angles, width: int = 752, height: int = 480,
                intrinsics=(458.654, 457.296, 367.215, 248.375), seed: int = 7,
                radius: float = 2.0, center=(4.0, 2.0, 9.0), rise: float = 0.4,
                first_seed: int = 0):
    """Views of `BoxScene.default(seed)` from the orbit of `orbit_sequence`
    at the given angles (rad, in any order), looking at `center`: the
    camera sits at center + (radius sin a, rise sin 2a, -radius cos a), as
    `orbit_trajectory` places it. Frame i renders with noise seed
    first_seed + i. Returns (images (n, h, w) uint8, R_cw (n,3,3),
    t_cw (n,3))."""
    cx, cy, cz = center
    R, t = [], []
    for a in np.asarray(angles, np.float64):
        pos = np.array([cx + radius * np.sin(a), cy + rise * np.sin(2 * a),
                        cz - radius * np.cos(a)], np.float32)
        z = np.asarray(center, np.float32) - pos
        z = z / np.linalg.norm(z)
        x = np.cross(np.array([0.0, 1.0, 0.0], np.float32), z)
        x /= np.linalg.norm(x)
        R_cw = np.stack([x, np.cross(z, x), z], axis=-1).T.astype(np.float32)
        R.append(R_cw)
        t.append((-R_cw @ pos).astype(np.float32))
    R, t = np.stack(R), np.stack(t)
    scene = BoxScene.default(seed=seed)
    imgs, _ = _render_views(scene, R, t, width, height, intrinsics, (),
                            first_seed + np.arange(len(R)))
    return imgs, R, t


def orbit_stereo_sequence(n_frames: int, width: int, height: int, intrinsics, dist,
                          right, T_c1_c2, seed: int = 7, radius: float = 2.0,
                          center=(4.0, 2.0, 9.0), arc: float = 1.0, fps: float = 20.0):
    """`orbit_sequence`'s orbit seen by a raw stereo pair: the left camera
    (`intrinsics`, rad-tan `dist`) renders as `orbit_sequence` does, the
    right one (`right` = (intrinsics, dist)) from T_c1_c2, the pose of the
    right camera in the left, with seeds i + 500000.
    Returns (left (n, h, w) uint8, right, R_cw (n,3,3), t_cw (n,3),
    timestamps (n,)); the poses are the left camera's."""
    from orbslam3_tpu_torch.utils.synth import orbit_trajectory
    scene = BoxScene.default(seed=seed)
    R, t = orbit_trajectory(n_frames=n_frames, radius=radius, center=center, arc=arc)
    left, right_views = _render_views(scene, R, t, width, height, intrinsics, dist,
                                      np.arange(n_frames), right=right, T_c1_c2=T_c1_c2)
    return left, right_views, R, t, np.arange(n_frames) / fps


def excited_trajectory(n_frames: int, fps: float, imu_rate: float, center,
                       radius: float, arc: float, excitation: float = 0.06,
                       rot_excitation: float = 0.0, seed: int = 0, look: str = "center"):
    """An orbit with sinusoidal translational (and optionally rotational)
    excitation, and IMU samples consistent with it.

    Port of `orbslam3_tpu/datasets/synth_euroc.py:excited_trajectory`. The
    gaze `look` is 'center' (every view looks at `center` and shares
    landmarks) or 'tangent' (along the direction of travel, corridor-style:
    covisibility breaks behind the camera). Scale and the accelerometer bias are observable only
    under real acceleration and rotation, so the path shakes at 1.4-2.6 Hz.
    The dense path is sampled at the IMU rate and differentiated there.
    Returns (R_cw (F,3,3), t_cw (F,3), frame_idx, imu_t (K+1,), gyro (K,3),
    acc (K,3)); IMU row k is the midpoint sample of [imu_t[k], imu_t[k+1]],
    body == camera.
    """
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed + 77)
    T = n_frames / fps
    stride = int(round(imu_rate / fps))
    n_dense = n_frames * stride + 1
    t = np.arange(n_dense) / imu_rate
    cx, cy, cz = center
    th = arc * (t / T) - arc / 2
    C = np.stack([cx + radius * np.sin(th), cy + 0.4 * np.sin(2 * th),
                  cz - radius * np.cos(th)], axis=-1)
    freqs = rng.uniform(1.4, 2.6, 3)
    phases = rng.uniform(0, 2 * np.pi, 3)
    for ax in range(3):
        C[:, ax] += excitation * np.sin(2 * np.pi * freqs[ax] * t + phases[ax])
    if look == "tangent":
        d = np.gradient(C, axis=0)
        z = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    else:
        look_v = np.asarray(center, np.float64)[None] - C
        z = look_v / np.linalg.norm(look_v, axis=1, keepdims=True)
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(np.broadcast_to(up, z.shape), z)
    x = x / np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R_wc = np.stack([x, y, z], axis=-1)
    if rot_excitation > 0:
        rfreqs = rng.uniform(0.9, 1.9, 3)
        rphases = rng.uniform(0, 2 * np.pi, 3)
        ang = rot_excitation * np.sin(
            2 * np.pi * rfreqs[None, :] * t[:, None] + rphases[None, :])
        R_wc = R_wc @ Rotation.from_rotvec(ang).as_matrix()
    R_cw = np.swapaxes(R_wc, 1, 2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, C)

    dt = 1.0 / imu_rate
    g_w = np.array([0.0, 0.0, -9.81])
    a_w = (C[2:] - 2 * C[1:-1] + C[:-2]) / (dt * dt)  # at t[1..K-1]
    K = n_dense - 1
    Rel = np.einsum("kji,kjl->kil", R_wc[:-1], R_wc[1:])
    gyro = Rotation.from_matrix(Rel).as_rotvec() / dt
    a_mid = np.empty((K, 3))
    a_mid[1:-1] = 0.5 * (a_w[:-1] + a_w[1:])
    a_mid[0] = a_w[0]
    a_mid[-1] = a_w[-1]
    acc = np.einsum("kji,kj->ki", R_wc[:-1], a_mid - g_w[None])
    frame_idx = np.arange(n_frames) * stride
    return (R_cw[frame_idx].astype(np.float64), t_cw[frame_idx].astype(np.float64),
            frame_idx, t, gyro, acc)


@dataclasses.dataclass
class ViSequence:
    """A rendered mono-inertial sequence held in memory."""
    images: np.ndarray    # (F, H, W) uint8, or None
    R_cw: np.ndarray      # (F,3,3) ground-truth world->camera
    t_cw: np.ndarray      # (F,3)
    frame_ts: np.ndarray  # (F,) seconds
    imu_ts: np.ndarray    # (K,) seconds, each sample stamped at its interval's end
    gyro: np.ndarray      # (K,3) rad/s, body frame, with noise
    acc: np.ndarray       # (K,3) m/s^2, body frame, with noise
    R_wb: np.ndarray      # (F,3,3) ground-truth body rotations (body == camera)
    images_right: np.ndarray = None  # (F, H, W) uint8 of a stereo sequence


@dataclasses.dataclass
class RgbdSequence:
    """A rendered RGB-D sequence held in memory."""
    images: np.ndarray    # (F, H, W) uint8
    depth: np.ndarray     # (F, H, W) uint16, metres x depth_factor
    R_cw: np.ndarray      # (F,3,3) ground-truth world->camera
    t_cw: np.ndarray      # (F,3)
    frame_ts: np.ndarray  # (F,) seconds
    depth_factor: float   # the map's units per metre (TUM: 5000)


def vi_sequence(n_frames: int = 120, width: int = 752, height: int = 480,
                intrinsics=(458.654, 457.296, 367.215, 248.375), seed: int = 3,
                fps: float = 20.0, imu_rate: float = 200.0, radius: float = 3.0,
                arc: float = 1.0, excitation: float = 0.05,
                rot_excitation: float = 0.06, imu_noise: bool = True,
                render: bool = True, stereo_baseline: float = 0.0,
                pinhole_dist=(), stereo_rot=0.0, T_c1_c2=None,
                right=None) -> ViSequence:
    """The mono-inertial sequence of `orbslam3_tpu/datasets/synth_euroc.py:
    write_synth_euroc`, in memory: `excited_trajectory` around the centre
    of `BoxScene.default(seed)` raised 3 m, frames rendered with seed
    `seed * 1000 + i`, IMU noise of 2e-4 rad/s and 2e-3 m/s^2 drawn from
    `seed + 5`, timestamps from 100 s, and one IMU sample 5 ms before the
    first frame, as the writer lays them out (no png, no csv, no YAML).
    With ``render=False`` the images are left out (None).

    The writer's stereo options: `pinhole_dist` renders raw rad-tan images,
    and `stereo_baseline` > 0 adds the right view (`images_right`) from
    `stereo_extrinsics(stereo_baseline, stereo_rot)`, with seeds
    `seed * 1000 + i + 500000`. Beyond the writer, `T_c1_c2` gives the
    pair's extrinsics whole and `right` = (intrinsics, dist) a right camera
    of its own (default the left's)."""
    if T_c1_c2 is None and stereo_baseline > 0:
        T_c1_c2 = stereo_extrinsics(stereo_baseline, stereo_rot)
    scene = BoxScene.default(seed=seed)
    c = (scene.lo + scene.hi) / 2.0
    center = (float(c[0]), float(c[1]), float(c[2]) + 3.0)
    R_cw, t_cw, _, imu_t, gyro, acc = excited_trajectory(
        n_frames, fps, imu_rate, center, radius, arc, excitation=excitation,
        rot_excitation=rot_excitation, seed=seed)
    t0 = 100.0
    imgs = imgs_r = None
    if render:
        imgs, imgs_r = _render_views(scene, R_cw, t_cw, width, height, intrinsics,
                                     pinhole_dist, seed * 1000 + np.arange(n_frames),
                                     right=right, T_c1_c2=T_c1_c2)
    rng = np.random.default_rng(seed + 5)
    if imu_noise:
        gyro = gyro + rng.normal(0, 2e-4, gyro.shape)
        acc = acc + rng.normal(0, 2e-3, acc.shape)
    imu_ts = np.concatenate([[t0 - 0.005], t0 + imu_t[1:]])
    gyro = np.concatenate([gyro[:1], gyro])
    acc = np.concatenate([acc[:1], acc])
    return ViSequence(images=imgs, R_cw=R_cw, t_cw=t_cw,
                      frame_ts=t0 + np.arange(n_frames) / fps, imu_ts=imu_ts,
                      gyro=gyro, acc=acc, R_wb=np.swapaxes(R_cw, 1, 2),
                      images_right=imgs_r)


def rgbd_sequence(n_frames: int = 80, width: int = 320, height: int = 240,
                  intrinsics=None, fps: float = 20.0, seed: int = 0,
                  radius: float = 3.0, arc: float = 1.0,
                  depth_factor: float = 5000.0) -> RgbdSequence:
    """The RGB-D sequence of `orbslam3_tpu/datasets/tum_rgbd.py:
    write_synth_tum_rgbd`, in memory: `excited_trajectory` (3 cm of shake,
    no rotational excitation) around the centre of `BoxScene.default(seed)`
    raised 3 m, frames rendered with seed `seed * 1000 + i` and their exact
    registered depth quantized to uint16 at `depth_factor` as the writer's
    PNG holds it, TUM-era timestamps from 1305031100 s (no png, no list
    files, no YAML). `intrinsics` (fx, fy, cx, cy) default to the writer's
    (240, 240, width / 2, height / 2)."""
    if intrinsics is None:
        intrinsics = (240.0, 240.0, width / 2.0, height / 2.0)
    scene = BoxScene.default(seed=seed)
    c = (scene.lo + scene.hi) / 2.0
    center = (float(c[0]), float(c[1]), float(c[2]) + 3.0)
    R_cw, t_cw, _, _, _, _ = excited_trajectory(n_frames, fps, 200.0, center, radius,
                                                arc, excitation=0.03, seed=seed)
    imgs, depth = [], []
    for i in range(n_frames):
        img, d = scene.render(_K(intrinsics), R_cw[i], t_cw[i], width, height,
                              seed=seed * 1000 + i, return_depth=True)
        imgs.append(img)
        depth.append(np.clip(d * depth_factor, 0, 65535).astype(np.uint16))
    return RgbdSequence(images=np.stack(imgs), depth=np.stack(depth), R_cw=R_cw,
                        t_cw=t_cw, frame_ts=1305031100.0 + np.arange(n_frames) / fps,
                        depth_factor=depth_factor)


def imu_batches(frame_ts, imu_ts, gyro, acc):
    """Per-frame IMU batches in the tracker's queue format: for frame i the
    (ts, gyro(3,), acc(3,)) samples in (frame_ts[i-1], frame_ts[i]] (all
    samples up to the first frame for frame 0). Port of
    `orbslam3_tpu/datasets/euroc.py:imu_batches` on arrays."""
    out, j, prev = [], 0, -np.inf
    for t1 in frame_ts:
        batch = []
        while j < len(imu_ts) and imu_ts[j] <= t1:
            if imu_ts[j] > prev:
                batch.append((float(imu_ts[j]), gyro[j], acc[j]))
            j += 1
        prev = t1
        out.append(batch)
    return out
