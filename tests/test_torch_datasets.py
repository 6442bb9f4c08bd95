"""The port's dataset loaders and writers against the JAX package's, CPU.

Loaders: both packages read the same files (written by the JAX package's
writers) and must return the same paths, the same float64 timestamps,
equal IMU arrays, equal `imu_batches`, equal ground truth and its
interpolation, and equal pixels (the port decodes with its own PNG codec,
the JAX package with cv2). The cases are those of `tests/test_datasets.py`
(EuRoC, its IMU partition, TUM-VI's mocap0, KITTI) plus stereo, a times
file and the TUM RGB-D association.

Writers: on the same arguments the port's text files (data.csv, the IMU
and ground-truth csvs, config.yaml, the TUM lists) are byte for byte the
JAX writers', and their decoded pixels are within 1 grey level (the
renderers' bilinear texture sampling rounds differently; 0 on most
frames).
"""

import filecmp
import os
import shutil

import cv2
import numpy as np
import pytest

from orbslam3_tpu import datasets as jds
from orbslam3_tpu.datasets import synth_euroc as jsynth
from orbslam3_tpu.datasets import tum_rgbd as jtum
from orbslam3_tpu_torch import datasets as tds
from orbslam3_tpu_torch.datasets import synth_euroc as tsynth
from orbslam3_tpu_torch.datasets import tum_rgbd as ttum

PIXEL_TOL = 1          # grey levels (and depth units) between the renderers
SMALL = dict(n_frames=6, width=96, height=72, fx=70.0, fy=70.0)


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synthseq"))
    jsynth.write_synth_euroc(d, n_frames=12, width=160, height=120, fx=116.0, fy=116.0,
                             seed=7, n_features=600, arc=1.0, excitation=0.02,
                             stereo_baseline=0.1)
    return d


def _same_asl(a, b, images: bool = True):
    assert a.image_paths == b.image_paths
    assert a.image_paths_right == b.image_paths_right
    for name in ("image_ts", "imu_ts", "imu_gyro", "imu_acc", "gt_ts", "gt_p", "gt_q"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    if images:
        for i in range(len(a)):
            assert np.array_equal(a.read_image(i), b.read_image(i))
            if a.image_paths_right:
                assert np.array_equal(a.read_image(i, right=True),
                                      b.read_image(i, right=True))


def _same_batches(ja, ta):
    jb, tb = list(ja), list(ta)
    assert len(jb) == len(tb)
    for x, y in zip(jb, tb):
        assert len(x) == len(y)
        for (t0, g0, a0), (t1, g1, a1) in zip(x, y):
            assert t0 == t1 and np.array_equal(g0, g1) and np.array_equal(a0, a1)


@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_loader(seq_dir, stereo):
    j = jds.load_euroc(seq_dir, stereo=stereo)
    t = tds.load_euroc(seq_dir, stereo=stereo)
    _same_asl(j, t)
    assert len(t) == 12 and t.image_ts[0] == pytest.approx(100.0)
    # one IMU sample before the first frame (mono_inertial_euroc.cc)
    assert t.imu_ts[0] <= t.image_ts[0] < t.imu_ts[1]
    ts = np.linspace(t.image_ts[0], t.image_ts[-1], 17)
    assert np.array_equal(j.gt_positions_at(ts), t.gt_positions_at(ts))
    assert np.allclose(t.gt_positions_at(t.image_ts[:3]), t.gt_p[:3], atol=1e-9)


def test_imu_batches_partition(seq_dir):
    j, t = jds.load_euroc(seq_dir), tds.load_euroc(seq_dir)
    _same_batches(jds.imu_batches(j), tds.imu_batches(t))
    batches = list(tds.imu_batches(t))
    assert sum(len(b) for b in batches) == int(np.sum(t.imu_ts <= t.image_ts[-1]))
    prev = -np.inf
    for b, t1 in zip(batches, t.image_ts):
        for ts, gyr, acc in b:
            assert prev < ts <= t1 + 1e-12 and gyr.shape == (3,) and acc.shape == (3,)
        prev = t1


def test_times_file(seq_dir, tmp_path):
    """A reference-style times file picks (and orders) the frames."""
    ts_ns = np.loadtxt(os.path.join(seq_dir, "mav0", "cam0", "data.csv"), delimiter=",",
                       dtype=np.int64, usecols=0)
    tf = str(tmp_path / "times.txt")
    np.savetxt(tf, ts_ns[[5, 1, 3]], fmt="%d")
    j = jds.load_euroc(seq_dir, times_file=tf)
    t = tds.load_euroc(seq_dir, times_file=tf)
    _same_asl(j, t)
    assert len(t) == 3


def test_tumvi_layout(seq_dir, tmp_path):
    """TUM-VI shares the ASL layout with the ground truth under mocap0."""
    d = str(tmp_path / "tumvi")
    shutil.copytree(seq_dir, d)
    os.rename(os.path.join(d, "mav0", "state_groundtruth_estimate0"),
              os.path.join(d, "mav0", "mocap0"))
    j = jds.load_tumvi(d, stereo=True)
    t = tds.load_tumvi(d, stereo=True)
    _same_asl(j, t, images=False)
    assert t.gt_ts is not None and len(t.gt_ts) == 12
    assert tds.load_euroc(d).gt_ts is None
    with pytest.raises(ValueError):
        tds.load_euroc(d).gt_positions_at(t.image_ts)


@pytest.mark.parametrize("stereo", [False, True])
def test_kitti_loader(seq_dir, tmp_path, stereo):
    d = tmp_path / "kitti" / "00"
    src = jds.load_euroc(seq_dir, stereo=True)
    for sub, paths in (("image_0", src.image_paths), ("image_1", src.image_paths_right)):
        (d / sub).mkdir(parents=True)
        for i in range(4):
            shutil.copy(paths[i], str(d / sub / f"{i:06d}.png"))
    np.savetxt(str(d / "times.txt"), np.arange(5) * 0.1, fmt="%.6f")
    cols = np.zeros((4, 12))
    cols[:, [0, 5, 10]] = 1.0
    cols[:, 3] = np.arange(4)
    pf = str(tmp_path / "00.txt")
    np.savetxt(pf, cols, fmt="%.6e")
    j = jds.load_kitti(str(d), poses_file=pf, stereo=stereo)
    t = tds.load_kitti(str(d), poses_file=pf, stereo=stereo)
    assert t.image_paths == j.image_paths and t.image_paths_right == j.image_paths_right
    assert np.array_equal(t.image_ts, j.image_ts) and np.array_equal(t.gt_poses, j.gt_poses)
    assert len(t) == 4 and t.gt_poses.shape == (4, 3, 4)
    assert np.allclose(t.gt_poses[2, :, 3], [2, 0, 0])
    for i in range(4):
        assert np.array_equal(t.read_image(i), j.read_image(i))
        if stereo:
            assert np.array_equal(t.read_image(i, right=True), j.read_image(i, right=True))


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tum"))
    return jtum.write_synth_tum_rgbd(d, n_frames=8, width=96, height=72)


def _same_tum(j, t):
    assert t.rgb_paths == j.rgb_paths and t.depth_paths == j.depth_paths
    for name in ("image_ts", "gt_ts", "gt_p", "gt_q"):
        assert np.array_equal(getattr(t, name), getattr(j, name)), name
    for i in range(len(t)):
        assert np.array_equal(t.read_image(i), j.read_image(i))
        dj, dt = j.read_depth(i), t.read_depth(i)
        assert dt.dtype == dj.dtype == np.float32 and np.array_equal(dt, dj)
    ts = np.linspace(t.image_ts[0], t.image_ts[-1], 11)
    assert np.array_equal(t.gt_positions_at(ts), j.gt_positions_at(ts))


def test_tum_rgbd_loader(tum_dir, tmp_path):
    _same_tum(jtum.load_tum_rgbd(tum_dir), ttum.load_tum_rgbd(tum_dir))
    # an associate.py file: "t_rgb rgb/<t>.png t_depth depth/<t>.png"
    seq = ttum.load_tum_rgbd(tum_dir)
    af = str(tmp_path / "assoc.txt")
    with open(af, "w") as f:
        f.write("# associations\n")
        for i in (0, 2, 5):
            f.write(f"{seq.image_ts[i]:.6f} {os.path.relpath(seq.rgb_paths[i], tum_dir)} "
                    f"0 {os.path.relpath(seq.depth_paths[i], tum_dir)}\n")
    j = jtum.load_tum_rgbd(tum_dir, association_file=af)
    t = ttum.load_tum_rgbd(tum_dir, association_file=af)
    _same_tum(j, t)
    assert len(t) == 3


@pytest.mark.parametrize("seed", range(3))
def test_associate(seed):
    """Greedy nearest-stamp matching with TUM's jittered depth stamps,
    dropped frames and a max difference that rejects some pairs."""
    rng = np.random.default_rng(seed)
    a = np.sort(1305031100.0 + np.cumsum(rng.uniform(0.02, 0.05, 60)))
    b = np.sort(np.delete(a, rng.choice(60, 7, replace=False))
                + rng.uniform(0.001, 0.03, 53))
    for max_diff in (0.02, 0.01):
        pairs = ttum.associate(a, b, max_diff)
        assert pairs == jtum.associate(a, b, max_diff)
        assert len({i for i, _ in pairs}) == len({j for _, j in pairs}) == len(pairs)
        assert all(abs(a[i] - b[j]) < max_diff for i, j in pairs)


def _same_dirs(a: str, b: str) -> int:
    """Every text file byte-equal, every PNG's pixels within PIXEL_TOL;
    returns the largest pixel difference."""
    worst, n = 0, 0
    for root, _, files in os.walk(a):
        for fn in files:
            pa = os.path.join(root, fn)
            pb = os.path.join(b, os.path.relpath(pa, a))
            assert os.path.exists(pb), pb
            if fn.endswith(".png"):
                x = cv2.imread(pa, cv2.IMREAD_UNCHANGED).astype(np.int64)
                y = cv2.imread(pb, cv2.IMREAD_UNCHANGED).astype(np.int64)
                assert x.shape == y.shape
                worst = max(worst, int(np.abs(x - y).max()))
            else:
                assert filecmp.cmp(pa, pb, shallow=False), pa
            n += 1
    assert n == sum(len(f) for _, _, f in os.walk(b))
    assert worst <= PIXEL_TOL
    return worst


@pytest.mark.parametrize("kw", [
    dict(),
    dict(stereo_baseline=0.11),
    dict(fisheye=True, stereo_baseline=0.101, kb8_dist=(0.0035, 0.0007, -0.002, 0.0002)),
    dict(pinhole_dist=(-0.28, 0.07, 0.0002, 0.00002), stereo_baseline=0.11,
         stereo_rot=0.01),
    dict(look="tangent", rot_excitation=0.05, imu_noise=False),
], ids=["mono", "stereo", "fisheye", "distorted", "tangent"])
def test_euroc_writer(tmp_path, monkeypatch, kw):
    monkeypatch.delenv("ORB_SYNTH_CACHE", raising=False)
    jsynth.write_synth_euroc(str(tmp_path / "j"), **SMALL, **kw)
    tsynth.write_synth_euroc(str(tmp_path / "t"), **SMALL, **kw)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))


def test_euroc_writer_cache(tmp_path, monkeypatch):
    """With ORB_SYNTH_CACHE a second call copies the finished sequence."""
    monkeypatch.setenv("ORB_SYNTH_CACHE", str(tmp_path / "cache"))
    tsynth.write_synth_euroc(str(tmp_path / "a"), **SMALL)
    assert len(os.listdir(tmp_path / "cache")) == 1
    tsynth.write_synth_euroc(str(tmp_path / "b"), **SMALL)
    assert len(os.listdir(tmp_path / "cache")) == 1
    monkeypatch.delenv("ORB_SYNTH_CACHE")
    tsynth.write_synth_euroc(str(tmp_path / "c"), **SMALL)
    for other in ("b", "c"):
        assert _same_dirs(str(tmp_path / "a"), str(tmp_path / other)) == 0


@pytest.mark.parametrize("jitter", [True, False])
def test_tum_writer(tmp_path, jitter):
    jtum.write_synth_tum_rgbd(str(tmp_path / "j"), n_frames=4, width=96, height=72,
                              jitter_depth_ts=jitter)
    ttum.write_synth_tum_rgbd(str(tmp_path / "t"), n_frames=4, width=96, height=72,
                              jitter_depth_ts=jitter)
    _same_dirs(str(tmp_path / "j"), str(tmp_path / "t"))
    seq = ttum.load_tum_rgbd(str(tmp_path / "t"))
    assert len(seq) == 4 and seq.read_depth(0).max() > 0
