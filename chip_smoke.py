#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tracking front end on one NVIDIA card.

Usage, from the repository root on a machine with a card and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `orbslam3_tpu_torch/csrc/` with one
nvcc call, holds each kernel against its plain PyTorch version on the card,
drives the main path (`extract_features` -> `fused_track_pose`) at the
EuRoC operating point (752x480, 1200 features, 8 levels, x1.2; 2048
map-point candidates), checks the recovered pose, shows through the launch
counters that the main path ran both kernels, and times everything with
CUDA events (kernels by replaying a captured CUDA graph, so their device
time is not hidden behind host launch overhead). Each phase prints one
line with its wall seconds. The line
before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises, so the script
exits non-zero and prints no result; so does a machine without a card.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from orbslam3_tpu_torch import _build
from orbslam3_tpu_torch.core import lie
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.engine.track_program import fused_track_pose
from orbslam3_tpu_torch.kernels import hamming, image, patch
from orbslam3_tpu_torch.kernels import orb_descriptor as desc_k
from orbslam3_tpu_torch.vision.frame import extract_features

# The operating point: __graft_entry__.py (EuRoC ORBextractor.nFeatures
# 1200, 752x480, 8 levels, x1.2) and the tracker's defaults
# (engine/tracking.py TrackerConfig: local_points_cap 2048, radii
# 15/30/60/8 px, min_track_matches 20, min_inliers_ok 15, max_mp_dist 100).
H, W = 480, 752
N_FEATURES, N_LEVELS, SCALE = 1200, 8, 1.2
K_CANDIDATES = 2048
RADII = (15.0, 30.0, 60.0, 8.0)
MIN_MATCHES, MIN_INLIERS, MAX_DIST = 20, 15, 100
CAMERA = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0 fx fy cx cy
SEED = 0

# Bounds of the checks, with their reasons.
ROT_TOL = 1e-3      # rad: observations are exact reprojections of the map
TRANS_TOL = 5e-3    # m, at 2-8 m depth
MATCH_SHARE = 0.8   # of valid features matched after refinement
AGREE_POSE_TOL = 1e-5  # kernel vs plain front end: same ops, exact kernels

# Published H100 SXM peaks (NVIDIA data sheet; at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

FRAMES = 20
KERNEL_ITERS = 200
PLAIN_ITERS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"phase {name}: ok ({time.perf_counter() - t0:.2f} s)")


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, reps: int = 5) -> float:
    """Device milliseconds per call of `fn`: `iters` calls captured in one
    CUDA graph and replayed, so host launch overhead is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside capture: lazy init, allocator, library load
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def median_frame_ms(fn, frames: int = FRAMES) -> float:
    """Median milliseconds of `fn` over `frames` calls after two warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def textured_image(seed: int, h: int, w: int) -> torch.Tensor:
    """Integer-valued (h, w) image in [0, 255]: bicubically upsampled
    uniform noise, so FAST finds stable corners at every level."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(rng.uniform(0, 255, (h // 4 + 2, w // 4 + 2))
                             .astype(np.float32))
    up = F.interpolate(small[None, None], size=(h, w), mode="bicubic",
                       align_corners=False)[0, 0]
    return torch.clamp(torch.round(up), 0, 255)


def make_map(feats, camera: Camera, R_true, t_true, k: int, seed: int) -> dict:
    """`k` map-point candidates: the frame's valid keypoints back-projected
    at seeded depths under the pose (R_true, t_true), carrying the frame's
    own descriptors, and the rest distractors in view with random
    descriptors; in a seeded random order. Returns the tensors and, per
    candidate, the feature it was made from (-1 for a distractor)."""
    dev = feats.uv.device
    g = torch.Generator().manual_seed(seed)
    valid = feats.valid.cpu()
    src = torch.nonzero(valid).flatten()
    n_real = src.numel()
    n_fake = k - n_real
    uv = torch.cat([feats.uv.cpu()[src],
                    torch.rand(n_fake, 2, generator=g) * torch.tensor([W - 1.0, H - 1.0])])
    depth = 2.0 + 6.0 * torch.rand(k, generator=g)
    octave = torch.cat([feats.octave.cpu()[src],
                        torch.randint(0, N_LEVELS, (n_fake,), generator=g,
                                      dtype=torch.int32)])
    desc = torch.cat([feats.desc.cpu()[src],
                      torch.randint(-2 ** 31, 2 ** 31, (n_fake, 8), generator=g,
                                    dtype=torch.int64).to(torch.int32)])
    origin = torch.cat([src, torch.full((n_fake,), -1, dtype=torch.int64)])
    perm = torch.randperm(k, generator=g)
    uv, depth, octave, desc, origin = (x[perm] for x in (uv, depth, octave, desc, origin))
    R, t = R_true.cpu(), t_true.cpu()
    xc = camera.to("cpu").unproject(uv) * depth[:, None]
    pts = (xc - t) @ R  # R^T (xc - t)
    center = -(R.T @ t)
    dist = torch.linalg.norm(pts - center, dim=-1)
    max_d = dist * 1.2 ** octave.float()
    return dict(
        mp_pos=pts.to(dev), mp_desc=desc.to(dev),
        mp_valid=torch.ones(k, dtype=torch.bool, device=dev),
        mp_normal=((pts - center) / dist[:, None]).to(dev),
        mp_min_d=(max_d / 1.2 ** 7).to(dev), mp_max_d=max_d.to(dev),
        origin=origin.to(dev))


def track(feats, mp: dict, camera: Camera, R_pred, t_pred):
    """`fused_track_pose` with the tracker's settings, on the frame."""
    return fused_track_pose(
        mp["mp_pos"], desc_k.descriptor_planes(mp["mp_desc"]), mp["mp_valid"],
        mp["mp_normal"], mp["mp_min_d"], mp["mp_max_d"], camera,
        feats.uv, desc_k.descriptor_planes(feats.desc), feats.octave, feats.valid,
        R_pred, t_pred, R_pred, t_pred, False, RADII, MIN_MATCHES, MIN_INLIERS,
        max_dist=MAX_DIST, device=feats.uv.device)


def known_poses(dev):
    """The true pose and the perturbed prediction tracking starts from."""
    R_true = lie.so3_exp(torch.tensor([0.02, -0.05, 0.01], device=dev))
    t_true = torch.tensor([0.10, -0.05, 0.20], device=dev)
    R_pred = lie.so3_exp(torch.tensor([0.004, 0.006, -0.003], device=dev)) @ R_true
    t_pred = t_true + torch.tensor([0.03, -0.02, 0.04], device=dev)
    return R_true, t_true, R_pred, t_pred


def pose_error(R, t, R_true, t_true) -> tuple[float, float]:
    """(rotation angle in rad, translation distance): the angle from the
    skew part of R R_true^T, which stays precise for small angles."""
    dR = R @ R_true.T
    sin = torch.clamp(torch.linalg.norm(lie.vee(dR - dR.T)) * 0.5, max=1.0)
    return float(torch.asin(sin)), float(torch.linalg.norm(t - t_true))


@contextlib.contextmanager
def capture(module, name: str):
    """Record the arguments of every call of `module.name` in the block."""
    calls = []
    fn = getattr(module, name)

    def recorder(*args):
        calls.append(args)
        return fn(*args)

    setattr(module, name, recorder)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def plain_kernels():
    """Route the main path through the kernels' plain PyTorch versions."""
    saved = hamming.masked_top2, patch.gather_patches
    hamming.masked_top2 = lambda a, b, m: hamming.masked_top2_reference(
        hamming._as_words(a), hamming._as_words(b), m)
    patch.gather_patches = patch.gather_patches_reference
    try:
        yield
    finally:
        hamming.masked_top2, patch.gather_patches = saved


def window_case(dev, n: int, m: int, seed: int):
    """Packed descriptors and a window-shaped mask as `search_by_projection`
    builds it (octave-scaled 15 px windows around projected points), with
    tied minima (duplicated candidates) and rows with no candidate."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=g, dtype=torch.int64)
    b = torch.randint(-2 ** 31, 2 ** 31, (m, 8), generator=g, dtype=torch.int64)
    half = min(n, m) // 2
    b[half:2 * half] = b[:half]             # every tie twice
    a[:half] = b[:half] ^ (torch.randint(0, 2, (half, 8), generator=g) << 3)
    mp_uv = torch.rand(n, 2, generator=g) * torch.tensor([float(W), float(H)])
    f_uv = mp_uv[torch.randint(0, n, (m,), generator=g)] + 6 * torch.randn(m, 2, generator=g)
    f_oct = torch.randint(0, N_LEVELS, (m,), generator=g)
    r = RADII[0] * 1.2 ** f_oct.float()
    d2 = torch.sum((mp_uv[:, None, :] - f_uv[None, :, :]) ** 2, dim=-1)
    mask = d2 <= (r * r)[None, :]
    mask[::17] = False                      # rows with no candidate
    return (a.to(torch.int32).to(dev), b.to(torch.int32).to(dev),
            mask.contiguous().to(dev))


def check_top2(got, ref, label: str) -> int:
    idx, best, second = got
    ridx, rbest, rsecond = ref
    has = rbest < hamming.BIG
    if not (torch.equal(best, rbest) and torch.equal(second, rsecond)
            and torch.equal(idx[has], ridx[has]) and bool((best[~has] >= hamming.BIG).all())
            and torch.equal(idx, ridx)):
        raise AssertionError(f"K1 differs from its plain version ({label})")
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(got, ref))


def top2_library(pa, pb, mask):
    """One PyTorch formulation of K1 (yardstick only): +/-1 plane product,
    masked_fill, stable sort."""
    d = (hamming.N_BITS - (pa @ pb.T).float()) * 0.5
    v, i = torch.sort(d.masked_fill(~mask, float(hamming.BIG)), dim=1, stable=True)
    return i[:, 0], v[:, 0], v[:, 1]


def patch_library(img, y0, x0):
    """One PyTorch formulation of K2 (yardstick only): an unfold view of
    every 32x32 window, indexed at the corners."""
    return img.unfold(0, patch.PATCH, 1).unfold(1, patch.PATCH, 1)[y0.long(), x0.long()]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kernels = {}

    with phase("device+build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
        t0 = time.perf_counter()
        path, cached = _build.build()
        _build.library()
        log(f"build: {path.name} cached={cached} {time.perf_counter() - t0:.2f} s")

    camera = Camera.pinhole(*CAMERA, width=W, height=H, device=dev)
    img = textured_image(SEED, H, W).to(dev)

    with phase("K2 gather_patches vs plain"):
        atlas = image.gaussian_blur(image.build_atlas(img, N_LEVELS, SCALE))
        ah, aw = atlas.shape
        rows, _, _ = image.atlas_layout(H, W, N_LEVELS, SCALE)
        g = torch.Generator().manual_seed(SEED + 1)
        lvl = torch.randint(0, N_LEVELS, (N_FEATURES,), generator=g)
        m = image.ATLAS_MARGIN
        y_lvl = torch.tensor([rows[int(l)][0] for l in lvl])
        lh = torch.tensor([rows[int(l)][1] for l in lvl])
        lw = torch.tensor([rows[int(l)][2] for l in lvl])
        ys = y_lvl + m + (torch.rand(N_FEATURES, generator=g) * (lh - 2 * m)).long()
        xs = m + (torch.rand(N_FEATURES, generator=g) * (lw - 2 * m)).long()
        y0 = torch.clamp(ys - 16, 0, ah - 32).to(torch.int32).to(dev)
        x0 = torch.clamp(xs - 16, 0, aw - 32).to(torch.int32).to(dev)
        got = patch.gather_patches(atlas, y0, x0)
        ref = patch.gather_patches_reference(atlas, y0, x0)
        if not torch.equal(got, ref):
            raise AssertionError("K2 differs from its plain version")
        if not torch.equal(patch_library(atlas, y0, x0), ref):
            raise AssertionError("K2 yardstick differs from the plain version")
        k2_err = float((got - ref).abs().max())
        log(f"K2 exact on ({ah},{aw}) atlas, {N_FEATURES} patches: max |err| {k2_err}")

    with phase("K1 masked_top2 vs plain"):
        k1_err = 0
        for n, mcols, seed in ((K_CANDIDATES, N_FEATURES, 1), (37, 53, 2),
                               (2051, 1199, 3), (1, 1, 4), (64, 100, 5)):
            a, b, mask = window_case(dev, n, mcols, seed)
            if seed == 5:
                mask.zero_()  # every row empty
            got = hamming.masked_top2(a, b, mask)
            ref = hamming.masked_top2_reference(a, b, mask)
            k1_err = max(k1_err, check_top2(got, ref, f"{n}x{mcols}"))
            pa, pb = desc_k.descriptor_planes(a), desc_k.descriptor_planes(b)
            planes = hamming.masked_top2(pa, pb, mask)  # the wrapper packs
            check_top2(planes, ref, f"{n}x{mcols} from planes")
            log(f"K1 exact at ({n},{mcols}): {int(mask.sum())} candidates, "
                f"{int((~mask.any(1)).sum())} empty rows")

    with phase("front end at full width"):
        R_true, t_true, R_pred, t_pred = known_poses(dev)
        _build.launches.clear()
        feats = extract_features(img, n_features=N_FEATURES, n_levels=N_LEVELS,
                                 scale=SCALE)
        mp = make_map(feats, camera, R_true, t_true, K_CANDIDATES, SEED + 2)
        ok, res = track(feats, mp, camera, R_pred, t_pred)
        torch.cuda.synchronize()
        main_launches = dict(_build.launches)
        n_valid = int(feats.valid.sum())
        nm = int(res["nm"])
        rot_err, trans_err = pose_error(res["R"], res["t"], R_true, t_true)
        mask = res["vsel"]
        right = mp["origin"][res["sel"].long()[mask]] == res["fidx"].long()[mask]
        log(f"features {n_valid}/{N_FEATURES} valid; tracked={ok} matches {nm} "
            f"inliers {int(res['n_in'])} planted-correct {int(right.sum())}/{int(mask.sum())}; "
            f"rot err {rot_err:.3e} rad, trans err {trans_err:.3e} m")
        log(f"launches on the main path: {json.dumps(main_launches, sort_keys=True)}")
        if not ok or nm < MATCH_SHARE * n_valid:
            raise AssertionError(f"tracking failed: ok={ok} matches {nm} of {n_valid}")
        if rot_err > ROT_TOL or trans_err > TRANS_TOL:
            raise AssertionError(f"pose error {rot_err} rad / {trans_err} m over "
                                 f"{ROT_TOL} / {TRANS_TOL}")
        for name in (patch.KERNEL, hamming.KERNEL):
            if main_launches.get(name, 0) < 1:
                raise AssertionError(f"kernel {name} was not launched on the main path")

        with plain_kernels():
            feats_p = extract_features(img, n_features=N_FEATURES, n_levels=N_LEVELS,
                                       scale=SCALE)
            ok_p, res_p = track(feats_p, mp, camera, R_pred, t_pred)
        for name in ("uv", "octave", "desc", "valid", "angle", "response"):
            if not torch.equal(getattr(feats, name), getattr(feats_p, name)):
                raise AssertionError(f"features differ between kernel and plain: {name}")
        d_pose = max(float((res["R"] - res_p["R"]).abs().max()),
                     float((res["t"] - res_p["t"]).abs().max()))
        if ok_p != ok or int(res_p["nm"]) != nm or d_pose > AGREE_POSE_TOL:
            raise AssertionError(f"kernel and plain front ends disagree: pose {d_pose}")
        log(f"kernel vs plain front end on the card: features identical, "
            f"matches {nm} vs {int(res_p['nm'])}, max pose diff {d_pose:.3e}")

    with phase("timings"):
        extract_ms = median_frame_ms(lambda: extract_features(
            img, n_features=N_FEATURES, n_levels=N_LEVELS, scale=SCALE))
        track_ms = median_frame_ms(lambda: track(feats, mp, camera, R_pred, t_pred))
        log(f"extract_features {extract_ms:.3f} ms/frame, fused_track_pose "
            f"{track_ms:.3f} ms/frame (median of {FRAMES} frames)")

        # each kernel at the inputs the main path hands it on this frame
        with capture(patch, "gather_patches") as k2_calls, \
                capture(hamming, "masked_top2") as k1_calls:
            track(extract_features(img, n_features=N_FEATURES, n_levels=N_LEVELS,
                                   scale=SCALE), mp, camera, R_pred, t_pred)
        atlas, y0, x0 = k2_calls[0]
        n = y0.numel()
        cover = torch.zeros(atlas.shape, dtype=torch.bool, device=dev)
        r = torch.arange(patch.PATCH, device=dev)
        cover[(torch.clamp(y0.long(), 0, atlas.shape[0] - 32)[:, None] + r)[:, :, None],
              (torch.clamp(x0.long(), 0, atlas.shape[1] - 32)[:, None] + r)[:, None, :]] = True
        # bytes: the pixels the patches cover, the corners, the patches out
        k2_bound, k2_by = bound_ms(4 * int(cover.sum()) + 8 * n + 4 * n * 1024, 0)
        eager_ms = {patch.KERNEL: cuda_ms(lambda: patch.gather_patches(atlas, y0, x0),
                                          KERNEL_ITERS)}
        kernels[patch.KERNEL] = dict(
            name=patch.KERNEL, route="cuda", source="orbslam3_tpu_torch/csrc/patch_gather.cu",
            replaces="orbslam3_tpu/kernels/patch_pallas.py:91",
            launches=main_launches.get(patch.KERNEL, 0), max_abs_err=k2_err,
            ms=device_ms(lambda: patch.gather_patches(atlas, y0, x0), KERNEL_ITERS),
            plain_ms=device_ms(lambda: patch.gather_patches_reference(atlas, y0, x0),
                               PLAIN_ITERS),
            bound_ms=k2_bound, bound_by=k2_by,
            library_ms=device_ms(lambda: patch_library(atlas, y0, x0), PLAIN_ITERS))

        # K1: the first (narrow-window) search of the frame
        pa, pb, mask = k1_calls[0]
        a, b = hamming._as_words(pa), hamming._as_words(pb)
        nn, mm = mask.shape
        # bytes: the mask, both descriptor sets, three (N,) outputs;
        # operations: the allowed pairs as +/-1 int8 products
        k1_bound, k1_by = bound_ms(nn * mm + 32 * (nn + mm) + 12 * nn,
                                   2 * hamming.N_BITS * int(mask.sum()))
        pa, pb = pa.to(torch.bfloat16), pb.to(torch.bfloat16)
        lib = top2_library(pa, pb, mask)
        ref = hamming.masked_top2_reference(a, b, mask)
        has = ref[1] < hamming.BIG
        if not (torch.equal(lib[1].to(torch.int32), ref[1])
                and torch.equal(lib[2].to(torch.int32), ref[2])
                and torch.equal(lib[0][has].to(torch.int32), ref[0][has])):
            raise AssertionError("K1 yardstick differs from the plain version")
        eager_ms[hamming.KERNEL] = cuda_ms(lambda: hamming.masked_top2(a, b, mask),
                                           KERNEL_ITERS)
        kernels[hamming.KERNEL] = dict(
            name=hamming.KERNEL, route="cuda", source="orbslam3_tpu_torch/csrc/hamming_top2.cu",
            replaces="orbslam3_tpu/kernels/hamming_pallas.py:108",
            launches=main_launches.get(hamming.KERNEL, 0), max_abs_err=k1_err,
            ms=device_ms(lambda: hamming.masked_top2(a, b, mask), KERNEL_ITERS),
            plain_ms=device_ms(lambda: hamming.masked_top2_reference(a, b, mask),
                               PLAIN_ITERS),
            bound_ms=k1_bound, bound_by=k1_by,
            library_ms=device_ms(lambda: top2_library(pa, pb, mask), PLAIN_ITERS))
        log(f"K1 mask at the main path: ({nn},{mm}), {int(mask.sum())} candidates")
        for kv in kernels.values():
            log(f"{kv['name']}: device {kv['ms'] * 1e3:.2f} us (bound "
                f"{kv['bound_ms'] * 1e3:.2f} us by {kv['bound_by']}), plain "
                f"{kv['plain_ms'] * 1e3:.2f} us, library {kv['library_ms'] * 1e3:.2f} us "
                f"(device time, CUDA graph replay); eager call through the wrapper "
                f"{eager_ms[kv['name']] * 1e3:.2f} us; {kv['launches']} launches "
                f"on the main path")

    log(smi)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
