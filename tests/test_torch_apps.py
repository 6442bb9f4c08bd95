"""The port's ten dataset apps against the JAX package's, CPU.

Each app's `main` (`orbslam3_tpu_torch/apps/<name>.py`, ``--device cpu``)
runs beside the JAX app's (`apps/<name>.py`, ``--cpu``) on the same files:
sequences the port's writers put on disk at 376x240 with 600 features,
``--vocab none``, at most 14 frames. The monocular trackers of the port
take the two-view RANSAC samples the reference drew (`Tracker.sample_fn`,
as `tests/test_torch_slam_e2e.py` injects them); the stereo, fisheye and
RGB-D ones need none.

- The runners' saved trajectories (TUM or KITTI rows) have the same rows,
  the same timestamps, and camera centres within CENTRE_TOL (the images
  pass through each package's pyramid, whose resize differs by 2.4e-4
  grey levels; measured ~1e-6 m on the monocular run).
- `run_synth` (feature level): the same rows, centres within 2e-3, the
  tolerance of `tests/test_torch_slam_e2e.py` on the same world.
- `eval_ate` and `process_imu` print the same lines; `opt_analy` the same
  numbers within OPT_TOL (f32 Levenberg-Marquardt in two frameworks).
- `build_vocab` saves the same tree.
- `draw_traj` writes its figures where matplotlib is present and raises
  with the reason where it is not.
- `utils.timing.transfer_audit` counts no copy on CPU tensors, leaves
  stderr alone and lets errors through.
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import re
import shutil
import sys

import numpy as np
import pytest

from orbslam3_tpu_torch.datasets.synth_euroc import write_synth_euroc
from orbslam3_tpu_torch.datasets.tum_rgbd import write_synth_tum_rgbd
from test_torch_slam_e2e import reference_samples
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CENTRE_TOL = 5e-3     # m: image-level runs (tests/test_torch_stereo_e2e.py)
SYNTH_TOL = 2e-3      # feature-level run (tests/test_torch_slam_e2e.py)
OPT_TOL = 2e-3        # of a printed error (cm or ratio)
SIZE = dict(width=376, height=240, fx=229.0, fy=229.0, n_features=600)


def jax_app(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_app_{name}", ROOT / "apps" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name: str, argv: list, monkeypatch) -> tuple:
    """(return value, stdout) of the JAX app's main with `argv`."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = jax_app(name).main()
    return rc, buf.getvalue()


def run_port(name: str, argv: list) -> tuple:
    mod = importlib.import_module(f"orbslam3_tpu_torch.apps.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


@pytest.fixture
def injected(monkeypatch):
    """Every tracker of the port's `Slam` draws the reference's samples."""
    from orbslam3_tpu_torch.engine import system
    make = system.Slam._make_tracker

    def with_samples(self, client_id):
        tracker = make(self, client_id)
        tracker.sample_fn = reference_samples
        return tracker
    monkeypatch.setattr(system.Slam, "_make_tracker", with_samples)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    root = tmp_path_factory.mktemp("apps")
    euroc = write_synth_euroc(str(root / "euroc"), n_frames=14, seed=3, arc=0.3,
                              excitation=0.05, rot_excitation=0.06, stereo_baseline=0.11,
                              **SIZE)
    tumvi = write_synth_euroc(str(root / "tumvi"), n_frames=6, seed=3, arc=0.15,
                              excitation=0.05, rot_excitation=0.06, fisheye=True,
                              kb8_dist=(0.0035, 0.0007, -0.0021, 0.0002),
                              stereo_baseline=0.101, **SIZE)
    os.rename(os.path.join(tumvi, "mav0", "state_groundtruth_estimate0"),
              os.path.join(tumvi, "mav0", "mocap0"))
    tum = write_synth_tum_rgbd(str(root / "tum"), n_frames=6, width=376, height=240,
                               n_features=600, arc=0.3)
    return dict(root=root, euroc=euroc, tumvi=tumvi, tum=tum)


def same_tum_rows(a: str, b: str, tol: float) -> np.ndarray:
    ra, rb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
    assert ra.shape == rb.shape and len(ra) >= 3
    assert np.array_equal(ra[:, 0], rb[:, 0])
    np.testing.assert_allclose(rb[:, 1:4], ra[:, 1:4], atol=tol)
    return ra


def printed_ate_mm(text: str) -> float:
    return float(re.search(r"ATE RMSE \([^)]*\): ([0-9.]+) mm", text).group(1))


@pytest.mark.parametrize("flags,frames", [(["--imu"], 12), (["--stereo"], 6),
                                          (["--tumvi", "--stereo", "--imu"], 6)],
                         ids=["mono_inertial", "stereo", "tumvi_fisheye_stereo_inertial"])
def test_run_euroc(seqs, tmp_path, monkeypatch, injected, flags, frames):
    seq = seqs["tumvi"] if "--tumvi" in flags else seqs["euroc"]
    common = ["--seq", seq, "--vocab", "none", "--quiet", "--max-frames", str(frames)] + flags
    jrc, jout = run_jax("run_euroc", common + ["--cpu", "--save-tum", str(tmp_path / "j.txt")],
                        monkeypatch)
    trc, tout = run_port("run_euroc", common + ["--device", "cpu",
                                                "--save-tum", str(tmp_path / "t.txt")])
    assert trc == jrc == 0
    same_tum_rows(str(tmp_path / "j.txt"), str(tmp_path / "t.txt"), CENTRE_TOL)
    assert abs(printed_ate_mm(tout) - printed_ate_mm(jout)) <= 1e3 * CENTRE_TOL
    assert tout.splitlines()[0] == jout.splitlines()[0]   # "N frames, M IMU samples, GT=yes"


def test_run_euroc_atlas_round_trip(seqs, tmp_path, monkeypatch):
    """--save-atlas, then --load-atlas --localization, in both packages:
    the same maps with the same keyframe counts, the tracker on the same
    map. (Without a vocabulary nothing relocalizes; both packages' stereo
    initialization then adds its keyframe to the loaded map.)"""
    from orbslam3_tpu.engine import system as jsystem
    from orbslam3_tpu_torch.apps import run_euroc
    jslams = []
    init = jsystem.Slam.__init__

    def keep(self, *args, **kw):
        init(self, *args, **kw)
        jslams.append(self)
    monkeypatch.setattr(jsystem.Slam, "__init__", keep)

    def layout(slam):
        return ([(k, m.n_keyframes) for k, m in sorted(slam.atlas.maps.items())],
                slam.trackers[0].map.map_id)
    common = ["--seq", seqs["euroc"], "--stereo", "--vocab", "none", "--quiet",
              "--max-frames", "6"]
    tslams = []
    for pkg, atlas in (("jax", str(tmp_path / "j.npz")), ("port", str(tmp_path / "t.npz"))):
        for extra in (["--save-atlas", atlas], ["--load-atlas", atlas, "--localization"]):
            if pkg == "jax":
                assert run_jax("run_euroc", common + extra + ["--cpu"], monkeypatch)[0] == 0
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    out = run_euroc.run(common + extra + ["--device", "cpu"])
                assert out["rc"] == 0
                tslams.append(out["slam"])
    assert [layout(s) for s in tslams] == [layout(s) for s in jslams]
    assert layout(tslams[1])[0][0][1] > layout(tslams[0])[0][0][1] > 0


def test_run_rgbd(seqs, tmp_path, monkeypatch):
    common = ["--seq", seqs["tum"], "--vocab", "none", "--quiet"]
    run_jax("run_rgbd", common + ["--cpu", "--save-tum", str(tmp_path / "j.txt")], monkeypatch)
    rc, out = run_port("run_rgbd", common + ["--device", "cpu",
                                             "--save-tum", str(tmp_path / "t.txt")])
    assert rc == 0 and "metric ATE:" in out
    same_tum_rows(str(tmp_path / "j.txt"), str(tmp_path / "t.txt"), CENTRE_TOL)


def _kitti_layout(seqs, root: pathlib.Path) -> tuple[str, str]:
    """The EuRoC stereo sequence as a KITTI odometry sequence: image_0/1,
    times.txt, a poses file of the ground truth and a config with bf."""
    from orbslam3_tpu_torch.datasets import load_euroc
    src = load_euroc(seqs["euroc"], stereo=True)
    d = root / "kitti" / "00"
    for sub, paths in (("image_0", src.image_paths), ("image_1", src.image_paths_right)):
        (d / sub).mkdir(parents=True)
        for i in range(6):
            shutil.copy(paths[i], str(d / sub / f"{i:06d}.png"))
    np.savetxt(str(d / "times.txt"), src.image_ts[:6] - src.image_ts[0], fmt="%.6f")
    from scipy.spatial.transform import Rotation
    R = Rotation.from_quat(src.gt_q[:6][:, [1, 2, 3, 0]]).as_matrix()
    poses = np.concatenate([R, src.gt_p[:6, :, None]], axis=2).reshape(6, 12)
    pf = str(root / "00.txt")
    np.savetxt(pf, poses, fmt="%.9e")
    shutil.copy(os.path.join(seqs["euroc"], "config.yaml"), str(d / "config.yaml"))
    return str(d), pf


def test_run_kitti(seqs, tmp_path, monkeypatch):
    d, poses = _kitti_layout(seqs, tmp_path)
    common = ["--seq", d, "--poses", poses, "--vocab", "none", "--quiet"]
    run_jax("run_kitti", common + ["--cpu", "--save-kitti", str(tmp_path / "j.txt")],
            monkeypatch)
    rc, out = run_port("run_kitti", common + ["--device", "cpu",
                                              "--save-kitti", str(tmp_path / "t.txt")])
    assert rc == 0 and "metric ATE:" in out
    a, b = np.loadtxt(str(tmp_path / "j.txt")), np.loadtxt(str(tmp_path / "t.txt"))
    assert a.shape == b.shape == (6, 12)
    np.testing.assert_allclose(b.reshape(6, 3, 4)[:, :, 3], a.reshape(6, 3, 4)[:, :, 3],
                               atol=CENTRE_TOL)


def test_run_pixel(seqs, tmp_path, monkeypatch, injected):
    """Two sequences (the first and the last 7 frames) with
    `change_dataset` between them."""
    cam = os.path.join(seqs["euroc"], "mav0", "cam0")
    ts = np.loadtxt(os.path.join(cam, "data.csv"), delimiter=",", dtype=np.int64,
                    usecols=0)
    imu = os.path.join(seqs["euroc"], "mav0", "imu0", "data.csv")
    triples = []
    for k, part in enumerate((ts[:7], ts[7:])):
        tf = tmp_path / f"times{k}.txt"
        np.savetxt(str(tf), part, fmt="%d")
        triples += ["--seq", f"{os.path.join(cam, 'data')},{tf},{imu}"]
    common = ["--config", os.path.join(seqs["euroc"], "config.yaml"), "--vocab", "none",
              "--quiet"] + triples
    _, jout = run_jax("run_pixel", common + ["--cpu", "--save-tum", str(tmp_path / "j.txt")],
                      monkeypatch)
    rc, tout = run_port("run_pixel", common + ["--device", "cpu",
                                               "--save-tum", str(tmp_path / "t.txt")])
    assert rc == 0
    same_tum_rows(str(tmp_path / "j.txt"), str(tmp_path / "t.txt"), CENTRE_TOL)
    jinfo, tinfo = (eval(o.strip().splitlines()[-1]) for o in (jout, tout))
    for key in ("state", "n_kfs", "n_maps", "imu_initialized"):
        assert tinfo[key] == jinfo[key], key


def test_run_synth(tmp_path, monkeypatch, injected):
    common = ["--frames", "20", "--features", "400"]
    jrc, jout = run_jax("run_synth", common + ["--cpu", "--save-tum", str(tmp_path / "j.txt")],
                        monkeypatch)
    from orbslam3_tpu_torch.apps import run_synth
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = run_synth.run(common + ["--device", "cpu", "--save-tum", str(tmp_path / "t.txt")])
    assert out["rc"] == jrc
    same_tum_rows(str(tmp_path / "j.txt"), str(tmp_path / "t.txt"), SYNTH_TOL)
    jate = float(re.search(r"scale-aligned\): ([0-9.]+) mm", jout).group(1))
    assert abs(out["ate"] * 1e3 - jate) <= 1e3 * SYNTH_TOL


def _estimate(seq, path: str, t0: float) -> None:
    """A TUM file of the ground truth scaled, shifted and noised, its
    stamps 1 ms after the truth's, from `t0` s."""
    rng = np.random.default_rng(0)
    est = 0.7 * seq.gt_p + rng.normal(0, 0.01, seq.gt_p.shape) + [0.1, -0.2, 0.3]
    np.savetxt(path, np.column_stack([seq.gt_ts - seq.gt_ts[0] + t0 + 0.001, est,
                                      np.zeros((len(est), 3)), np.ones(len(est))]),
               fmt="%.9f")


def test_eval_ate(seqs, tmp_path, monkeypatch):
    """A TUM estimate against a EuRoC ground-truth csv with EuRoC-era
    stamps (MH_01 starts at 1403636579.76 s), with and without scale, and
    with a max difference no pair meets."""
    from orbslam3_tpu_torch.datasets import load_euroc
    seq = load_euroc(seqs["euroc"])
    src = os.path.join(seqs["euroc"], "mav0", "state_groundtruth_estimate0", "data.csv")
    rows = np.genfromtxt(src, delimiter=",", comments="#")
    gt = str(tmp_path / "gt.csv")
    t0_ns = 1403636579763555584
    with open(gt, "w") as f:
        f.write("#timestamp,p_RS_R_x,p_RS_R_y,p_RS_R_z,q_RS_w,q_RS_x,q_RS_y,q_RS_z\n")
        for r in rows:
            ns = t0_ns + int(round((r[0] - rows[0, 0])))
            f.write(",".join([str(ns)] + [f"{x:.9f}" for x in r[1:]]) + "\n")
    tum = str(tmp_path / "est.txt")
    _estimate(seq, tum, t0_ns * 1e-9)
    for extra in ([], ["--scale"], ["--max-dt", "0.0005"]):
        jrc, jout = run_jax("eval_ate", [gt, tum] + extra, monkeypatch)
        trc, tout = run_port("eval_ate", [gt, tum] + extra)
        assert trc == jrc and tout == jout
    assert trc == 2
    assert "alignment_scale 1.4" in run_port("eval_ate", [gt, tum, "--scale"])[1]


def test_eval_ate_synthetic_stamps(seqs, tmp_path, monkeypatch):
    """The writers' csv stamps start at 100 s (1e11 ns): the JAX app reads
    them as seconds and associates nothing; the port reads a csv's stamps
    as nanoseconds (ROADMAP, known faults in the reference)."""
    from orbslam3_tpu_torch.datasets import load_euroc
    seq = load_euroc(seqs["euroc"])
    gt = os.path.join(seqs["euroc"], "mav0", "state_groundtruth_estimate0", "data.csv")
    tum = str(tmp_path / "est.txt")
    _estimate(seq, tum, seq.gt_ts[0])
    assert run_jax("eval_ate", [gt, tum], monkeypatch)[0] == 2
    rc, out = run_port("eval_ate", [gt, tum, "--scale"])
    assert rc == 0 and f"compared_pose_pairs {len(seq.gt_ts)} pairs" in out
    assert "alignment_scale 1.4" in out


def test_build_vocab(seqs, tmp_path, monkeypatch):
    """The same descriptors through each package's front end train the
    same tree."""
    common = ["--seq", seqs["euroc"], "--k", "4", "--depth", "2", "--max-frames", "3",
              "--stride", "4", "--features", "400"]
    run_jax("build_vocab", common + ["--cpu", "--out", str(tmp_path / "j.npz")], monkeypatch)
    rc, out = run_port("build_vocab", common + ["--device", "cpu",
                                                "--out", str(tmp_path / "t.npz")])
    assert rc == 0 and "saved 16-word vocabulary" in out
    with np.load(str(tmp_path / "j.npz")) as a, np.load(str(tmp_path / "t.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert np.array_equal(a[key], b[key]), key
    from orbslam3_tpu_torch.place.vocab import Vocabulary
    assert Vocabulary.load(str(tmp_path / "t.npz")).n_words == 16


def test_process_imu(seqs, tmp_path, monkeypatch):
    imu = os.path.join(seqs["euroc"], "mav0", "imu0", "data.csv")
    _, jout = run_jax("process_imu", ["--imu", imu], monkeypatch)
    rc, tout = run_port("process_imu", ["--imu", imu])
    assert rc == 0 and tout == jout and "IMU.NoiseGyro:" in tout


def _numbers(text: str) -> list[float]:
    return [float(x) for x in re.findall(r"[-+]?\d+\.\d+", text)]


@pytest.mark.parametrize("mode,count", [("pos", 1), ("regu", 1), ("imu", 1), ("calib", 2)])
def test_opt_analy(monkeypatch, mode, count):
    common = ["--mode", mode, "--n", "10"]
    _, jout = run_jax("opt_analy", common + ["--cpu"], monkeypatch)
    rc, tout = run_port("opt_analy", common + ["--device", "cpu"])
    assert rc == 0
    assert [ln.split(":")[0] for ln in tout.splitlines()] == \
        [ln.split(":")[0] for ln in jout.splitlines()]
    jn, tn = _numbers(jout), _numbers(tout)
    assert len(tn) == len(jn) == count
    np.testing.assert_allclose(tn, jn, atol=OPT_TOL * 100, rtol=OPT_TOL)


def test_opt_analy_key(monkeypatch):
    """The keyed mode: the JAX app hands its optimizer the ranges of all
    W + 1 poses and raises (ROADMAP, known faults in the reference); the
    port hands it those of poses 1..W, so 'key' and 'all' run and 'all'
    prints the other modes' numbers as they run alone."""
    with pytest.raises(ValueError, match="inconsistent sizes"):
        run_jax("opt_analy", ["--mode", "key", "--n", "10", "--cpu"], monkeypatch)
    rc, out = run_port("opt_analy", ["--mode", "all", "--n", "10", "--device", "cpu"])
    assert rc == 0 and len(_numbers(out)) == 6
    key = float(re.search(r"key   : mean position error ([0-9.]+) cm", out).group(1))
    assert 0.0 < key < 30.0


def test_draw_traj(seqs, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    traj = str(tmp_path / "t.txt")
    rc, _ = run_port("run_euroc", ["--seq", seqs["euroc"], "--stereo", "--vocab", "none",
                                   "--quiet", "--max-frames", "4", "--device", "cpu",
                                   "--save-tum", traj, "--save-atlas",
                                   str(tmp_path / "a.npz")])
    gt = os.path.join(seqs["euroc"], "mav0", "state_groundtruth_estimate0", "data.csv")
    args = ["--traj", traj, "--traj2", traj, "--gt", gt, "--align", "--atlas",
            str(tmp_path / "a.npz")]
    run_jax("draw_traj", args + ["--out", str(tmp_path / "j.png"), "--map-out",
                                 str(tmp_path / "jm.png")], monkeypatch)
    rc, out = run_port("draw_traj", args + ["--out", str(tmp_path / "p.png"), "--map-out",
                                            str(tmp_path / "pm.png"), "--device", "cpu"])
    assert rc == 0
    for name in ("j.png", "jm.png", "p.png", "pm.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_draw_traj_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing the app raises and says why."""
    np.savetxt(str(tmp_path / "t.txt"), np.zeros((3, 8)))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        run_port("draw_traj", ["--traj", str(tmp_path / "t.txt"),
                               "--out", str(tmp_path / "x.png")])


def test_transfer_audit_on_cpu(capfd):
    import torch

    from orbslam3_tpu_torch.utils import timing
    box = {}
    with timing.transfer_audit(box) as b:
        x = torch.arange(6.0).reshape(2, 3)
        assert float((x @ x.T).sum()) == 83.0
        print("stderr line kept", file=sys.stderr)
        assert b is box
    assert (box["h2d"], box["d2h"], box["syncs"]) == (0, 0, 0)
    assert "stderr line kept" in capfd.readouterr().err
    box = {}
    with pytest.raises(KeyError, match="inside"):
        with timing.transfer_audit(box):
            raise KeyError("inside")
    assert box["h2d"] == box["d2h"] == 0


@pytest.mark.parametrize("name,argv", [
    ("run_euroc", ["--seq", "{euroc}", "--vocab", "none"]),
    ("run_rgbd", ["--seq", "{tum}", "--vocab", "none"]),
    ("build_vocab", ["--seq", "{euroc}", "--max-frames", "1"]),
    ("opt_analy", ["--mode", "pos", "--n", "2"]),
])
def test_apps_default_to_the_card(seqs, name, argv):
    """Started without --device an app computes on the card; on a machine
    without one it raises instead of falling back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    argv = [a.format(**seqs) for a in argv]
    with pytest.raises(RuntimeError, match="CUDA requested"):
        run_port(name, argv)
