"""The JAX package's dataset apps on the runner phase's written sequences,
on the CPU.

Writes the sequences `chip_smoke.py`'s runner phase drives through the port
on the card (`chip_smoke.write_runner_sequences`: the port's writers, the
same files byte for byte), runs the JAX package's app mains on them
(`apps/run_euroc.py --imu --save-tum` on the EuRoC layout, `apps/run_euroc.py
--tumvi --stereo --imu` on the TUM-VI layout, `apps/run_rgbd.py` on the TUM
RGB-D layout; the shipped vocabulary, as the apps default) and prints one
JSON line: per run the init frame (the first frame tracked), the IMU-init
frame (the first frame after which the map's IMU is initialized), the final
`iba_stage`, the tracked share from the init frame, the keyframe and point
counts, the metric ATE unrounded (the app's own computation: all three
runs fix the scale) beside the ATE the app prints,
and the seconds. `chip_smoke.py`'s RUNNER_REFERENCE cites this line.

The apps are called as they are; only the JAX `Slam`'s track methods are
wrapped to read each frame's outcome.

Usage (from the repository root; tens of minutes on the CPU at full width,
~3 GB; --run picks one):

    python scripts/port_runner_reference.py [--run euroc|tumvi|tum] [--out-dir DIR]
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (the sequences' definitions)
from orbslam3_tpu.datasets import load_euroc, load_tumvi  # noqa: E402
from orbslam3_tpu.datasets.tum_rgbd import load_tum_rgbd  # noqa: E402

RUNS = {
    "euroc": ("run_euroc.py", ["--imu"]),
    "tumvi": ("run_euroc.py", ["--tumvi", "--stereo", "--imu"]),
    "tum": ("run_rgbd.py", []),
}


def load_app(name: str):
    spec = importlib.util.spec_from_file_location(name[:-3], os.path.join(ROOT, "apps", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def recording():
    """Wraps the JAX `Slam.track_*` to record, per frame, whether a pose
    came back and the map's IMU flags; yields the record."""
    from orbslam3_tpu.engine import system
    rec = dict(tracked=[], imu_init_frame=-1, slam=None)
    saved = {name: getattr(system.Slam, name)
             for name in ("track_monocular", "track_stereo", "track_rgbd")}

    def wrap(fn):
        def tracked(self, *args, **kw):
            out = fn(self, *args, **kw)
            rec["slam"] = self
            rec["tracked"].append(out is not None)
            if rec["imu_init_frame"] < 0 and self.trackers[0].map.imu_initialized:
                rec["imu_init_frame"] = len(rec["tracked"]) - 1
            return out
        return tracked

    for name, fn in saved.items():
        setattr(system.Slam, name, wrap(fn))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(system.Slam, name, fn)


def run_app(run: str, seq_dir: str, out_dir: str) -> dict:
    app, flags = RUNS[run]
    traj = os.path.join(out_dir, f"{run}_traj.txt")
    argv = [app, "--seq", seq_dir, "--cpu", "--quiet", "--save-tum", traj] + flags
    mod = load_app(app)
    t0 = time.perf_counter()
    buf = io.StringIO()
    saved_argv = sys.argv
    sys.argv = argv
    try:
        with recording() as rec, contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = saved_argv
    text = buf.getvalue()
    sys.stderr.write(text)
    m = rec["slam"].trackers[0].map
    tracked = rec["tracked"]
    init = tracked.index(True) if any(tracked) else -1
    after = tracked[init:] if init >= 0 else []
    printed = None
    hit = re.search(r"ATE RMSE \((?:scale-aligned )?\d+ frames\): ([0-9.]+) mm", text)
    if hit:
        printed = float(hit.group(1)) * 1e-3
    hit = re.search(r"metric ATE: ([0-9.]+) cm", text)
    if hit:
        printed = float(hit.group(1)) * 1e-2
    # the app's ATE unrounded: its own computation, on the recorded Slam
    from orbslam3_tpu.evaluation import ate_rmse
    loader = load_tum_rgbd if run == "tum" else (load_tumvi if run == "tumvi" else load_euroc)
    seq = loader(seq_dir)
    poses = rec["slam"]._full_poses(0)
    ts = np.array([p[0] for p in poses])
    ate = ate_rmse(np.array([p[2] for p in poses]), seq.gt_positions_at(ts), with_scale=False)
    return dict(rc=rc, frames=len(tracked), init_frame=init,
                imu_init_frame=rec["imu_init_frame"], iba_stage=int(m.iba_stage),
                tracked_share=round(sum(after) / max(len(after), 1), 4),
                keyframes=int(m.n_keyframes), points=int(m.n_points),
                ate_metric=round(float(ate), 6), ate_printed=printed,
                seconds=round(time.perf_counter() - t0, 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", choices=sorted(RUNS), action="append")
    ap.add_argument("--out-dir", default="")
    args = ap.parse_args()
    runs = args.run or ["euroc", "tumvi", "tum"]
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="runner_ref_")
    t0 = time.perf_counter()
    seqs = chip_smoke.write_runner_sequences(out_dir, which=runs)
    print(f"wrote {sorted(seqs)} under {out_dir} in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    report = {run: run_app(run, seqs[run], out_dir) for run in runs}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
