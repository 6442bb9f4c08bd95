#!/usr/bin/env python3
"""Controls and planted faults of the comparison that decides `correct`.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds <s> \\
        --plants none,half,kernels_low

sets the cell up once per seed, in one process, and measures one window
after another, each with the timed path broken as its plant says (`none`:
the program as it is), printing per window one JSON line of every number
the reference compared (`harness.reference`) and whether it came out
correct. Plants that change what the system computes (the kernels') go
last, since the windows after them start from the state they left.
`--source-distortion` renders the frames (or projects the phones'
keypoints) through the source's rad-tan distortion (the configuration's
`camera.source_dist`) and gives it to the settings, as the source
deployment runs.
The benchmark's own runs never run this.

The controls, each breaking one guarantee the configuration states, by
the step a later change could be tempted to take:
- `half` (every frame handed in gets its own pose): every other call of a
  client is not tracked and answers with that client's previous pose;
- `kernels_low` (K1 and K2 are exact): the kernels one precision down,
  K1's Hamming distances from half of each descriptor's 256 bits
  (doubled), K2's patches gathered from the image rounded to bfloat16.
- `lost_half` (every frame handed in is answered with its pose): every
  other call of a client answers LOST (no pose), as a tracker that gave
  up on its costly frames would;
- `drop_client` (every client of the shared map is served; the edge
  cell): every call of client 1 answers LOST, so client 0 has the lock;
- `scale` (poses are metric once the IMU is initialized): the map, with
  its keyframes' velocities, re-gauged to 1.2 times its scale at the
  window's opening (`MapState.apply_scaled_rotation`, the step the IMU
  initialization and the scale refinement take), undone after it;
- `tilt` (poses are gravity-aligned): the map turned by 3 degrees about
  its x axis at the window's opening, undone after it.
The faults a run of these cells can have:
- `stale`: every call answers with the window's first pose, as if the
  system's state did not advance;
- `altered`: one answer in five turned by 0.1 rad and moved by 1 m where
  it is produced;
- `k1_altered`: K1's best distance one higher on every row.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys

import numpy as np
import torch

import run as pb  # noqa: E402  (portbench/run.py, on the path as this file's directory)


def _wrap_answers(cell, change):
    """Wrap the call that produces each frame's answer (`track_monocular`,
    or `track_features` under the edge server's lock) with `change(client,
    answer) -> answer`. Returns the undo function."""
    name = "track_features" if hasattr(cell, "phones") else "track_monocular"
    inner = getattr(cell.slam, name)

    def wrapped(*a, **kw):
        out = inner(*a, **kw)
        return None if out is None else change(kw.get("client_id", 0), out)

    setattr(cell.slam, name, wrapped)
    return lambda: setattr(cell.slam, name, inner)


def plant_kernels_low(cell, mods):
    k1, k2 = mods.hamming.masked_top2, mods.patch.gather_patches
    big = 1 << 20

    def half(desc_a, desc_b, mask, policy=None):
        a = mods.hamming._as_words(desc_a)[:, :4].long() & 0xFFFFFFFF
        b = mods.hamming._as_words(desc_b)[:, :4].long() & 0xFFFFFFFF
        d = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
        for w in range(4):
            x = a[:, w, None] ^ b[None, :, w]
            x = x - ((x >> 1) & 0x55555555)
            x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
            x = (x + (x >> 4)) & 0x0F0F0F0F
            d += ((x * 0x01010101) & 0xFFFFFFFF) >> 24
        d = torch.where(mask.bool(), 2 * d, big)
        best, idx = d.min(1)
        idx = torch.where(best < big, idx, 0)
        second = d.scatter(1, idx[:, None], big).min(1).values
        return idx.int(), best.int(), second.int()

    def bf16_patches(img, ys, xs):
        return k2(img.to(torch.bfloat16).float(), ys, xs)

    mods.hamming.masked_top2, mods.patch.gather_patches = half, bf16_patches

    def undo():
        mods.hamming.masked_top2, mods.patch.gather_patches = k1, k2
    return undo


def plant_half(cell, mods):
    state = {}

    def change(c, out):
        n, prev = state.get(c, (0, None))
        state[c] = (n + 1, out if n % 2 == 0 or prev is None else prev)
        return state[c][1]
    return _wrap_answers(cell, change)


def plant_stale(cell, mods):
    first = {}
    return _wrap_answers(cell, lambda c, out: first.setdefault("pose", out))


def plant_altered(cell, mods):
    count = [0]

    def change(c, out):
        count[0] += 1
        if count[0] % 5:
            return out
        turn = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(0.1), -np.sin(0.1)],
                         [0.0, np.sin(0.1), np.cos(0.1)]], np.float32)
        R, t = np.asarray(out[0]), np.asarray(out[1])
        return turn @ R, turn @ t + np.array([1.0, 0.0, 0.0], np.float32)
    return _wrap_answers(cell, change)


def plant_k1_altered(cell, mods):
    k1 = mods.hamming.masked_top2

    def altered(desc_a, desc_b, mask, policy=None):
        idx, best, second = k1(desc_a, desc_b, mask, policy=policy)
        return idx, best + 1, second

    mods.hamming.masked_top2 = altered
    return lambda: setattr(mods.hamming, "masked_top2", k1)


def plant_lost_half(cell, mods):
    count = {}

    def change(c, out):
        count[c] = count.get(c, 0) + 1
        return out if count[c] % 2 else None
    return _wrap_answers(cell, change)


def plant_drop_client(cell, mods):
    return _wrap_answers(cell, lambda c, out: None if c == 1 else out)


def _regauge(cell, R: np.ndarray, s: float):
    """Re-gauge the active map as its IMU initialization does, between two
    frames (under the edge server's lock where there is one)."""
    edge = getattr(cell.slam, "_edge_lock", None) if hasattr(cell, "phones") else None
    with edge if edge is not None else contextlib.nullcontext():
        m = cell.slam.atlas.active
        with m.lock:
            m.apply_scaled_rotation(R, s)


def plant_scale(cell, mods):
    _regauge(cell, np.eye(3), 1.2)
    return lambda: _regauge(cell, np.eye(3), 1.0 / 1.2)


def plant_tilt(cell, mods):
    a = np.radians(3.0)
    R = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(a), -np.sin(a)], [0.0, np.sin(a), np.cos(a)]])
    _regauge(cell, R, 1.0)
    return lambda: _regauge(cell, R.T, 1.0)


PLANTS = {"none": None, "half": plant_half, "lost_half": plant_lost_half,
          "drop_client": plant_drop_client, "scale": plant_scale, "tilt": plant_tilt,
          "kernels_low": plant_kernels_low, "stale": plant_stale, "altered": plant_altered,
          "k1_altered": plant_k1_altered}


def source_distortion(config: dict) -> dict:
    """The configuration with the source's rad-tan distortion: in the
    settings text (Camera1.k1, k2, p1, p2) and in the traffic's camera."""
    c = json.loads(json.dumps(config))
    c["camera"]["dist"] = list(c["camera"]["source_dist"])
    t = c["settings"]
    for k, v in zip(("k1", "k2", "p1", "p2"), c["camera"]["dist"]):
        t = re.sub(rf"Camera1\.{k}: \S+", f"Camera1.{k}: {v!r}", t)
    c["settings"] = t
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plants", default="none", help="comma-separated, of " + ", ".join(PLANTS))
    ap.add_argument("--source-distortion", action="store_true")
    args = ap.parse_args(argv)
    plants = args.plants.split(",")
    for p in plants:
        if p not in PLANTS:
            raise SystemExit(f"unknown plant {p!r}")
    for seed in (int(s) for s in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                      trace=0)
        ss = pb.prepare(run_args, shrink=source_distortion if args.source_distortion else None,
                        unlisted=True)
        for i, plant in enumerate(plants):
            res = pb.measure(ss, plant=PLANTS[plant], release=i == len(plants) - 1)
            print(json.dumps(dict(workload=args.workload, plant=plant, seed=seed,
                                  correct=res["correct"], attempted=res["attempted"],
                                  failed=res["failed"], numbers=ss.numbers,
                                  frames_per_s=res["metrics"]["frames_per_s"]["value"],
                                  setup_s=ss.setup_s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
