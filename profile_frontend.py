#!/usr/bin/env python3
"""Profile one frame of the port's front end on the card with torch.profiler.

Usage, from the repository root on a machine with a card:

    python3 profile_frontend.py [--out DIR]

Same frame, map and settings as chip_smoke.py. After a warm-up it
profiles one `extract_features` and one `fused_track_pose` call and
prints, for each, the wall time, the device-busy time (sum of kernel
times) and the ops that take most host and device time. Chrome traces go
to DIR (default profile_out/).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from orbslam3_tpu_torch.core.camera import Camera
from orbslam3_tpu_torch.vision.frame import extract_features


def profiled(name: str, fn, out_dir: str) -> None:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernel rows only: the aten rows repeat their kernels' device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
    syncs = sum(e.count for e in events
                if "Synchronize" in e.key or e.key == "cudaMemcpyAsync")
    print(f"== {name}: wall {wall_ms:.3f} ms, device busy {device_us / 1e3:.3f} ms "
          f"({100 * device_us / 1e3 / wall_ms:.1f}%), kernel launches {launches}, "
          f"sync/copy calls {syncs}")
    print(events.table(sort_by="self_cpu_time_total", row_limit=25, max_name_column_width=60))
    print(events.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60))
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frontend: no CUDA card", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    camera = Camera.pinhole(*cs.CAMERA, width=cs.W, height=cs.H, device=dev)
    img = cs.textured_image(cs.SEED, cs.H, cs.W).to(dev)
    R_true, t_true, R_pred, t_pred = cs.known_poses(dev)

    def extract():
        return extract_features(img, n_features=cs.N_FEATURES, n_levels=cs.N_LEVELS,
                                scale=cs.SCALE)

    feats = extract()
    mp = cs.make_map(feats, camera, R_true, t_true, cs.K_CANDIDATES, cs.SEED + 2)
    profiled("extract_features", extract, args.out)
    profiled("fused_track_pose", lambda: cs.track(feats, mp, camera, R_pred, t_pred),
             args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
