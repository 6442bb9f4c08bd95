"""The plain reference that decides `correct`: what the timed path returned,
judged against what the traffic generator knows to be true.

NumPy in float64. It reads the port's outputs (the poses returned, the
map's keyframes, points and velocities, and the inputs and outputs of
sampled kernel launches) only to judge them, and works out everything it
compares them with from the generator's truth: the path, the box's faces
or the landmark field, and the kernels' definitions.

The trajectory arithmetic is a frozen copy of
`orbslam3_tpu_torch/evaluation.py` (`umeyama_alignment`, `ate_rmse`,
`vi_metrics`' gravity tilt) and `chip_smoke.py:trajectory_ate`.
"""

from __future__ import annotations

import numpy as np

BIG = 1 << 20  # K1's distance of a row with no allowed candidate


def umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool):
    """(s, R, t) with gt ~= s R est + t, least squares (Horn / Umeyama)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    xe, xg = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(xg.T @ xe / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / max((xe ** 2).sum() / len(est), 1e-12)) \
        if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def centres(R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
    return -np.einsum("nji,nj->ni", np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64))


def trajectory_numbers(R_cw, t_cw, client, R_gt, t_gt) -> dict:
    """Poses returned (world->camera, in the map's world) against the true
    ones, several clients in one map: `ate_m` the rigidly aligned RMS
    centre error (the IMU fixes the scale, so this is the metric error);
    `rpe_p90_m` the 90th percentile over each client's consecutive poses
    of the error of the step between them, rotated into the truth's frame;
    `rpe_rot_p90_deg` the same percentile of the angle between the
    rotation from each pose to the next and the true one (no alignment
    needed); `repeated_poses` how many of a client's poses equal its
    previous one bit for bit (a frame answered without being tracked; the
    path never stands still)."""
    R_cw, t_cw = np.asarray(R_cw), np.asarray(t_cw)
    est, gt = centres(R_cw, t_cw), centres(R_gt, t_gt)
    _, R, t = umeyama(est, gt, with_scale=False)
    err = est @ R.T + t - gt
    steps, turns, repeats = [], [], 0
    client = np.asarray(client)
    R_e, R_g = np.asarray(R_cw, np.float64), np.asarray(R_gt, np.float64)
    for c in np.unique(client):
        i = np.nonzero(client == c)[0]
        steps.append((est[i[1:]] - est[i[:-1]]) @ R.T - (gt[i[1:]] - gt[i[:-1]]))
        # R_cw(next) R_cw(this)^T is the step's rotation, in either world
        d_e = R_e[i[1:]] @ np.swapaxes(R_e[i[:-1]], 1, 2)
        d_g = R_g[i[1:]] @ np.swapaxes(R_g[i[:-1]], 1, 2)
        cos = (np.trace(np.swapaxes(d_g, 1, 2) @ d_e, axis1=1, axis2=2) - 1.0) / 2.0
        turns.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
        repeats += int(np.sum(np.all(R_cw[i[1:]] == R_cw[i[:-1]], axis=(1, 2))
                              & np.all(t_cw[i[1:]] == t_cw[i[:-1]], axis=1)))
    steps = np.concatenate(steps) if steps else np.zeros((0, 3))
    turns = np.concatenate(turns) if turns else np.zeros(0)
    if not len(steps):
        return dict(ate_m=np.inf, rpe_p90_m=np.inf, rpe_rot_p90_deg=np.inf,
                    repeated_poses=repeats)
    return dict(ate_m=float(np.sqrt(np.mean(np.sum(err ** 2, -1)))),
                rpe_p90_m=float(np.percentile(np.linalg.norm(steps, axis=1), 90)),
                rpe_rot_p90_deg=float(np.percentile(turns, 90)), repeated_poses=repeats)


def map_numbers(kf_R, kf_t, kf_v, R_gt, t_gt, v_gt, pts, surface_dist) -> dict:
    """The map at the end of the window against the truth at each
    keyframe's frame: `kf_ate_m` the keyframe centres' rigid ATE;
    `kf_scale_err` |s - 1| of their similarity alignment; `tilt_deg` the
    median over keyframes of the angle between the map's gravity (-z) and
    the true one seen through the keyframe's true rotation; `kf_vel_mps`
    the median error of the keyframes' velocities; `map_pts_m` the median
    distance of the map's points, moved by the keyframes' rigid alignment,
    to the true surfaces (`surface_dist` of (N,3) points)."""
    kf_R = np.asarray(kf_R, np.float64)
    c = centres(kf_R, kf_t)
    g = centres(R_gt, t_gt)
    s, _, _ = umeyama(c, g, with_scale=True)
    _, R, t = umeyama(c, g, with_scale=False)
    g_map = np.einsum("nji,njk,k->ni", kf_R, np.asarray(R_gt, np.float64),
                      np.array([0.0, 0.0, -1.0]))
    tilt = np.degrees(np.arccos(np.clip(-g_map[:, 2], -1.0, 1.0)))
    vel = np.linalg.norm(np.asarray(kf_v, np.float64) @ R.T - v_gt, axis=1)
    pts_gt = np.asarray(pts, np.float64) @ R.T + t
    return dict(kf_ate_m=float(np.sqrt(np.mean(np.sum((c @ R.T + t - g) ** 2, -1)))),
                kf_scale_err=abs(s - 1.0), tilt_deg=float(np.median(tilt)),
                kf_vel_mps=float(np.median(vel)),
                map_pts_m=float(np.median(surface_dist(pts_gt))) if len(pts_gt) else np.inf)


def box_surface_dist(box):
    """Distance of points to the faces of an axis-aligned box ((lo, hi) per
    axis): inside, to the nearest face; outside, to the box."""
    lo = np.array([b[0] for b in box], np.float64)
    hi = np.array([b[1] for b in box], np.float64)

    def dist(p):
        inside = np.all((p >= lo) & (p <= hi), axis=1)
        d_in = np.minimum(p - lo, hi - p).min(axis=1)
        d_out = np.linalg.norm(np.maximum(np.maximum(lo - p, p - hi), 0.0), axis=1)
        return np.where(inside, d_in, d_out)
    return dist


def nearest_dist(landmarks: np.ndarray, block: int = 256):
    """Distance of points to the nearest of `landmarks` (P,3)."""
    L = np.asarray(landmarks, np.float64)

    def dist(p):
        out = np.empty(len(p))
        for s in range(0, len(p), block):
            d = p[s:s + block, None, :] - L[None]
            out[s:s + block] = np.sqrt((d ** 2).sum(-1).min(1))
        return out
    return dist


_BITS = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _bytes(desc: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 of packed (N, 8) 32-bit words or of (N, 256) +/-1
    planes (any fixed bit order gives the same distances)."""
    if desc.shape[-1] == 256:
        return np.packbits(desc > 0, axis=1)
    return np.ascontiguousarray(desc).view(np.uint8).reshape(len(desc), 32)


def masked_top2(a: np.ndarray, b: np.ndarray, mask: np.ndarray, block: int = 64):
    """K1 by its definition: (n,.) and (m,.) descriptors (`_bytes`) and an
    (n,m) mask -> per row the lowest column at the least Hamming
    distance among the allowed ones, that distance and the least distance
    among the other allowed columns; a row with none gets column 0 and
    distances BIG, a row with one gets second BIG."""
    n, m = mask.shape
    a8, b8 = _bytes(a), _bytes(b)
    idx = np.zeros(n, np.int64)
    best = np.full(n, BIG, np.int64)
    second = np.full(n, BIG, np.int64)
    cols = np.arange(m)
    for s in range(0, n, block):
        d = _BITS[a8[s:s + block, None, :] ^ b8[None]].sum(-1, dtype=np.int64)
        d = np.where(mask[s:s + block], d, BIG)
        j = np.argmin(d, axis=1)              # the first, so the lowest column
        idx[s:s + block] = np.where(d.min(1) < BIG, j, 0)
        best[s:s + block] = d.min(1)
        second[s:s + block] = np.where(cols[None] == j[:, None], BIG, d).min(1)
    return idx, best, second


def k1_rows_differ(samples) -> int:
    """Rows, over the sampled K1 launches, where the port's (idx, best,
    second) differ from the definition's."""
    bad = 0
    for a, b, mask, out in samples:
        ref = masked_top2(a, b, mask)
        bad += int(np.sum(np.any(np.stack([np.asarray(o, np.int64) != r
                                           for o, r in zip(out, ref)]), axis=0)))
    return bad


def k2_values_differ(samples) -> int:
    """Patch values, over the sampled K2 launches, that differ from the
    image's pixels at the clamped corners."""
    bad = 0
    for img, ys, xs, out in samples:
        h, w = img.shape
        r = np.arange(32)
        y0 = np.clip(ys.astype(np.int64), 0, h - 32)
        x0 = np.clip(xs.astype(np.int64), 0, w - 32)
        ref = img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]
        bad += int(np.sum(ref != out))
    return bad
