"""The comparison that decides `correct`, with the timed path broken.

The rest of a run (set-up, warm-up, window, tap, reference, limits) is
driven on the CPU at half the cells' size (376x240, 600 features), the
look for a card skipped: a sound window must come out correct, and each
control and each fault a cell can have (`control.py`) must come out not
correct. One set-up per cell serves its windows in turn; the plants that
change what the system computes (the kernels') come last. It takes
some minutes on the CPU.
"""

import argparse
import json
import re

import pytest
import torch

import control
import run as pb

# each mix's controls and faults (`edge.two_phones` is kept for a later
# PR, out of BENCHMARK.json); those that change what the system computes
# (the kernels') last
# (`scale` is not among the EuRoC mix's here: at this half size its 1.2
# re-gauge reads 0.057 at a 10 s window's close, the local inertial BA having
# pulled the window's keyframes back toward the IMU's scale; the limit is
# held against its readings on the card at the cell's size)
PLANTS = {
    "euroc_mi.fast": ["none", "half", "lost_half", "stale", "altered", "tilt", "kernels_low",
                      "k1_altered"],
    "edge.two_phones": ["none", "half", "lost_half", "drop_client", "stale", "altered", "scale",
                        "tilt", "kernels_low", "k1_altered"],
}
OVERRIDES = {"euroc_mi.fast": {"texture_size": 512}, "edge.two_phones": {"budget_init": 600}}


def half_size(config: dict) -> dict:
    """The configuration at half its image size and 600 features."""
    c = json.loads(json.dumps(config))
    cam = c["camera"]
    cam["width"], cam["height"] = cam["width"] // 2, cam["height"] // 2
    cam["intrinsics"] = [v / 2 for v in cam["intrinsics"]]
    t = c["settings"]
    for k, v in zip(("fx", "fy", "cx", "cy"), cam["intrinsics"]):
        t = re.sub(rf"Camera1\.{k}: [0-9.]+", f"Camera1.{k}: {v}", t)
    t = re.sub(r"Camera.width: \d+", f"Camera.width: {cam['width']}", t)
    t = re.sub(r"Camera.height: \d+", f"Camera.height: {cam['height']}", t)
    c["settings"] = re.sub(r"ORBextractor.nFeatures: \d+", "ORBextractor.nFeatures: 600", t)
    return c


@pytest.fixture(scope="module")
def session(request):
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    args = argparse.Namespace(workload=request.param, seed=2**31 + 17, seconds=10.0, trace=0)
    ss = pb.prepare(args, device="cpu", overrides=OVERRIDES[request.param], shrink=half_size,
                    unlisted=True)
    yield ss
    ss.cell.release()
    torch.set_num_threads(threads)


@pytest.mark.parametrize("session,plant", [(c, p) for c in sorted(PLANTS) for p in PLANTS[c]],
                         indirect=["session"])
def test_correct_holds_sound_runs_and_fails_broken_ones(session, plant):
    res = pb.measure(session, plant=control.PLANTS[plant], release=False)
    failing = [k for k, c in res["checks"].items() if not pb.passes(c)]
    assert res["correct"] is (plant == "none"), (plant, res["checks"])
    assert bool(failing) is (plant != "none")
