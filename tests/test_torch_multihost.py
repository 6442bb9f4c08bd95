"""The port's two-process app (`python -m orbslam3_tpu_torch.apps.multihost`)
on the CPU: two gloo ranks, a map weld over TCP blocks, a joint sharded BA.

- At a tiny size (40 frames, 800 points, 4 BA iterations; ~15 s alone)
  both processes join one group of 2 ranks, host 0 welds host 1's
  keyframes, both ranks print the same joint-BA line (its cost does not
  rise: the app raises otherwise), and both print their success marker.
- At the JAX test's size (`tests/test_multihost.py`: 80 frames, 1000
  points, 4 iterations), marked slow as that test is, the merged-map ATE
  is held to its bound, 120 mm.
- The entry points ask for the card and NCCL by default; on this machine
  both raise, and nothing falls back to the CPU or to gloo.

Every process has a deadline and is killed at it.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch.apps import multihost as app
from orbslam3_tpu_torch.distributed import multihost
from torch_parity import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TEST_ATE_MM = 120.0  # tests/test_multihost.py


def _run_app(n_frames: int, n_points: int, ba_iters: int, timeout: float):
    """Both processes of the app on the CPU over gloo; returns their outputs."""
    args = ["--coordinator", f"127.0.0.1:{free_port()}", "--map-port", str(free_port()),
            "--n-frames", str(n_frames), "--n-points", str(n_points),
            "--ba-iters", str(ba_iters), "--device", "cpu", "--backend", "gloo"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "orbslam3_tpu_torch.apps.multihost", "--process-id", str(pid),
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the app passed its {timeout} s deadline")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
    return outs


def _joint_ba_line(out: str) -> str:
    (line,) = [ln for ln in out.splitlines() if "joint BA on" in ln]
    return line.split("]", 1)[1].rsplit(" in ", 1)[0]  # without the rank and the time


def _check(outs) -> float:
    out0, out1 = outs
    assert "[0] joined: 2 ranks" in out0 and "[1] joined: 2 ranks" in out1
    assert re.search(r"\[0\] welded [1-9]\d* remote KFs", out0)
    assert _joint_ba_line(out0) == _joint_ba_line(out1)
    assert "MULTIHOST OK (worker)" in out1
    (ok,) = [ln for ln in out0.splitlines() if ln.startswith("MULTIHOST OK welded_kfs=")]
    ate = float(ok.split("ate_mm=")[1])
    assert np.isfinite(ate)
    return ate


def test_two_process_app_on_the_cpu():
    _check(_run_app(40, 800, 4, timeout=240))


@pytest.mark.slow
def test_two_process_weld_and_joint_ba():
    ate = _check(_run_app(80, 1000, 4, timeout=900))
    assert ate < JAX_TEST_ATE_MM, f"merged-map ATE {ate} mm"


def test_the_app_asks_for_the_card_and_nccl():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        app.main(["--process-id", "0", "--coordinator", f"127.0.0.1:{free_port()}"])
    with pytest.raises((RuntimeError, ValueError)):  # this torch has no NCCL
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    assert not torch.distributed.is_initialized()
