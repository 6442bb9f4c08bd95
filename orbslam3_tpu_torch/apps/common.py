"""What the dataset runners share: the device flag, the vocabulary flag,
and a per-frame record of a run (decode, resize and track times; whether
each frame tracked; the frame the IMU initialized at)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def add_device_arg(ap) -> None:
    ap.add_argument('--device', default=None,
                    help="torch device (default: the card); 'cpu' to run on the CPU")


def load_vocab(spec: str):
    """--vocab: 'auto' (the shipped 10^5-word vocabulary, None if absent),
    'none', or a path to a saved vocabulary."""
    if spec == 'none':
        return None
    from orbslam3_tpu_torch.place.vocab import Vocabulary, load_default_vocabulary
    return load_default_vocabulary() if spec == 'auto' else Vocabulary.load(spec)


def no_hook(i, slam, log):
    """The runners' default frame hook: nothing around frame i."""
    return contextlib.nullcontext()


class FrameLog:
    """Per-frame host times (ms) of a run and its tracking outcome. On the
    card, `track` synchronizes before it stops the clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.decode_ms: list[float] = []
        self.resize_ms: list[float] = []
        self.track_ms: list[float] = []
        self.tracked: list[bool] = []
        self.imu_init_frame = -1

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def decode(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def resize(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.resize_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def track(self, slam, fn, *args, **kw):
        """`fn(*args, **kw)` (a `Slam.track_*`), timed; records whether it
        returned a pose and whether client 0's map has its IMU initialized."""
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self._sync()
        self.track_ms.append((time.perf_counter() - t0) * 1e3)
        self.tracked.append(out is not None)
        if self.imu_init_frame < 0 and slam.trackers[0].map.imu_initialized:
            self.imu_init_frame = len(self.tracked) - 1
        return out

    @property
    def init_frame(self) -> int:
        return self.tracked.index(True) if any(self.tracked) else -1

    def tracked_share(self) -> float:
        """Share of the frames from the first tracked one on that tracked."""
        after = self.tracked[self.init_frame:] if self.init_frame >= 0 else []
        return sum(after) / max(len(after), 1)

    def summary(self) -> dict:
        def pct(xs):
            a = np.asarray(xs, np.float64)
            if not len(a):
                return None
            return dict(p50=float(np.percentile(a, 50)), p90=float(np.percentile(a, 90)),
                        max=float(a.max()))
        return dict(frames=len(self.tracked), init_frame=self.init_frame,
                    imu_init_frame=self.imu_init_frame,
                    tracked_share=self.tracked_share(), track_ms=pct(self.track_ms),
                    decode_ms=pct(self.decode_ms), resize_ms=pct(self.resize_ms))
