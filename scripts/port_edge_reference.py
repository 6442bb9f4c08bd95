"""The JAX package's edge server on the port's packet stream, on CPU.

Renders the mono-inertial phase's `vi_sequence` (the frames `chip_smoke.py`
reuses for its edge phase), builds the JAX package's
`Slam(sensor=IMU_MONOCULAR)` with the shipped vocabulary from
`chip_smoke.euroc_yaml(imu=True, n_features=EDGE_FEATURES)` (synchronous
mapping, global BA inline) behind the JAX package's `EdgeServer` on
127.0.0.1, and drives it with `chip_smoke.edge_phase_report`, the code the
card runs: two of the port's `FakePhone`s in lockstep, whose features come
from the port's `extract_features` on the CPU at the budgets the JAX server
sends back. It prints one JSON line: client 0's init and IMU-init frames,
its tracked share and metric ATE, client 1's tracked frames, the frame it
relocalized at and its pose errors after the map's Sim3 alignment, the
budget sequences, the events, the seconds. `chip_smoke.py` takes its edge
bounds from these numbers. With `--frames` the stream is lengthened (up
to 80) when the IMU needs more.

With `--atlas` it instead runs the vocabulary phase (`loop_phase_report`)
through the JAX package at `--width`/`--height`/`--features`, saves the
atlas, loads it into a fresh `Slam(load_atlas_from=...)` and runs
`chip_smoke.localize_loaded` (client 1's views in localization mode), to
show that the JAX package relocalizes on a loaded atlas too.

Usage (from the repository root; each takes tens of minutes and a few GB):

    python scripts/port_edge_reference.py
    python scripts/port_edge_reference.py --atlas --width 376 --height 240 --features 600
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import _cpu_env  # noqa: E402,F401  (pins jax to the CPU)

import chip_smoke as smoke  # noqa: E402  (the phase's code and constants)
from orbslam3_tpu.config import Settings  # noqa: E402
from orbslam3_tpu.core.camera import Camera  # noqa: E402
from orbslam3_tpu.edge.server import EdgeServer  # noqa: E402
from orbslam3_tpu.engine.local_mapping import LocalMapperConfig  # noqa: E402
from orbslam3_tpu.engine.system import Slam, SystemConfig  # noqa: E402
from orbslam3_tpu.engine.tracking import TrackerConfig  # noqa: E402
from orbslam3_tpu.place.vocab import Vocabulary  # noqa: E402
from orbslam3_tpu.slam_map.map_state import MapConfig  # noqa: E402
from orbslam3_tpu_torch.datasets.render import imu_batches, vi_sequence  # noqa: E402
from orbslam3_tpu_torch.edge.client_sim import FakePhone  # noqa: E402
from orbslam3_tpu_torch.place.vocab import default_vocabulary_path  # noqa: E402
from orbslam3_tpu_torch.vision.frame import extract_features  # noqa: E402


def settings(text: str, sensor: str) -> Settings:
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(text)
    try:
        return Settings.from_yaml(f.name, sensor)
    finally:
        os.unlink(f.name)


def edge(frames: int) -> dict:
    seq = vi_sequence(smoke.VI_FRAMES, smoke.W, smoke.H, smoke.CAMERA)
    batches = imu_batches(seq.frame_ts, seq.imu_ts, seq.gyro, seq.acc)
    st = settings(smoke.euroc_yaml(imu=True, n_features=smoke.EDGE_FEATURES), "imu_monocular")
    cfg = st.system_config()
    cfg.mapper = LocalMapperConfig(**smoke.VI_CADENCE)
    slam = Slam(st.camera(), cfg, vocab=Vocabulary.load(default_vocabulary_path()))
    slam.loop_closer.gba_background = False
    server = EdgeServer(slam.track_edge, host="127.0.0.1", slam_port=0, acoustic_port=0,
                        max_clients=2)

    def extract(img, budget):
        return extract_features(img, n_features=budget, n_levels=smoke.N_LEVELS,
                                scale=smoke.SCALE, device="cpu")

    t0 = time.perf_counter()
    rep = smoke.edge_phase_report(slam, server, extract, seq, batches,
                                  smoke.edge_plan(frames), FakePhone)
    seconds = time.perf_counter() - t0
    recs = rep.pop("records")
    rep["states"] = [(r["client"], r["frame_id"], r["ok"], r["state"], r["keyframes"],
                      r["points"]) for r in recs]
    rep["server_ms"] = [r["ms"] for r in recs]
    rep.update(frames=frames, features=smoke.EDGE_FEATURES, seconds=seconds)
    return rep


def atlas(width: int, height: int, features: int) -> dict:
    s = width / 752.0
    intr = tuple(v * s for v in smoke.CAMERA)
    seqs = smoke.loop_sequences(width, height, intr)
    cam = Camera.pinhole(*intr, width=width, height=height)
    cfg = SystemConfig(map=MapConfig(features_per_frame=features),
                       tracker=TrackerConfig(n_features=features))
    vocab = Vocabulary.load(default_vocabulary_path())
    slam = Slam(cam, cfg, vocab=vocab)
    slam.loop_closer.gba_background = False
    t0 = time.perf_counter()
    out = dict(width=width, height=height, features=features)
    rep = smoke.loop_phase_report(slam, seqs, progress=lambda name, part: print(
        f"after {name}: {json.dumps(part)}", file=sys.stderr, flush=True))
    out["vocab_phase"] = {k: rep[k] for k in ("reloc", "localize")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "atlas.npz")
        slam.save_atlas(path)
        out["atlas_bytes"] = os.path.getsize(path)
        loaded = Slam(cam, cfg, vocab=vocab, load_atlas_from=path)
    loaded.loop_closer.gba_background = False
    out["loaded"] = smoke.localize_loaded(loaded, seqs)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=smoke.EDGE_FRAMES,
                    help="phone 0's frames (the edge phase's clip)")
    ap.add_argument("--atlas", action="store_true",
                    help="the vocabulary phase, save, load, localization mode")
    ap.add_argument("--width", type=int, default=smoke.W)
    ap.add_argument("--height", type=int, default=smoke.H)
    ap.add_argument("--features", type=int, default=smoke.N_FEATURES)
    args = ap.parse_args()
    out = (atlas(args.width, args.height, args.features) if args.atlas
           else edge(args.frames))
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
