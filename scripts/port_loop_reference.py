"""The JAX package's mono SLAM with a vocabulary on the port's rendered
sessions, on CPU: a loop, a merge, a relocalization, localization mode.

Renders `chip_smoke.loop_sequences` (the sessions `chip_smoke.py` drives
through the port on the card), builds the JAX package's `Slam` with the
shipped vocabulary (`orbslam3_tpu/assets/vocab_100k.npz`) and global BA
inline, and runs:

(a) the loop orbit through `track_monocular`;
(b) `change_dataset()`, then the merge session;
(c) `add_client(1)` fed the relocalization frames, then
    `activate_localization_mode()` and client 0 on the last frames.

It prints one JSON line: per loop and merge event the frame of its
session, the keyframe's slot and uid, the matched keyframe's slot, uid and
frame of the loop session, the Sim3 scale and inliers; the tracked shares,
keyframe and point counts and the Sim3-aligned ATE of the loop session;
the merged map's keyframes per session; client 1's tracked frames, the
frame it relocalized at and its pose errors after the merged map's Sim3
alignment (`orbslam3_tpu_torch.evaluation.aligned_pose_errors`); the
keyframes localization mode added; the seconds. `chip_smoke.py` takes its
bounds from these numbers.

Usage (from the repository root; at 752x480 and 1200 features it takes
tens of minutes and a few GB):

    python scripts/port_loop_reference.py
    python scripts/port_loop_reference.py --width 376 --height 240 --features 600
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)
import numpy as np  # noqa: E402

import chip_smoke as smoke  # noqa: E402  (the sessions and constants only)
from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.engine.system import Slam, SystemConfig  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig  # noqa: E402
from orbslam3_tpu.place.vocab import Vocabulary  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu_torch.evaluation import aligned_pose_errors  # noqa: E402
from orbslam3_tpu_torch.place.vocab import default_vocabulary_path  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=smoke.W)
    ap.add_argument("--height", type=int, default=smoke.H)
    ap.add_argument("--features", type=int, default=smoke.N_FEATURES)
    args = ap.parse_args()
    s = args.width / 752.0
    intr = tuple(v * s for v in smoke.CAMERA)
    seqs = smoke.loop_sequences(args.width, args.height, intr)
    cam = Camera.pinhole(*intr, width=args.width, height=args.height)
    cfg = SystemConfig(map=MapConfig(features_per_frame=args.features),
                       tracker=TrackerConfig(n_features=args.features))
    slam = Slam(cam, cfg, vocab=Vocabulary.load(default_vocabulary_path()))
    slam.loop_closer.gba_background = False
    t0 = time.perf_counter()
    out = dict(width=args.width, height=args.height, features=args.features)
    out.update(smoke.loop_phase_report(
        slam, seqs, progress=lambda name, part: print(
            f"after {name}: {json.dumps(part)}", file=sys.stderr, flush=True)))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
