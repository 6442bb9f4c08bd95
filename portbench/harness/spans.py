"""The benchmark's own instrumentation around its calls into the port.

`Spans` times each call on the host clock, in every run; the traced run
moves them onto the profiler's clock to name the device's idle gaps.
`KernelTap` wraps the port's two CUDA kernels' Python
entry points (`kernels.hamming.masked_top2`, `kernels.patch.gather_patches`)
for the window: in every run it keeps a seeded reservoir sample of
launches, inputs and outputs copied on the device, for the reference to
judge after the window; in the traced run it also records each launch's
sizes for the roofline readers.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time

import numpy as np


class Spans:
    def __init__(self):
        self.records: list[dict] = []   # name, t0, t1 (perf_counter s), and the call's fields
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        rec = dict(name=name, **fields)
        rec["t0"] = time.perf_counter()
        try:
            yield rec
        finally:
            rec["t1"] = time.perf_counter()
            with self._lock:
                self.records.append(rec)


class Reservoir:
    """k items drawn uniformly from a stream of unknown length, seeded."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self._rng = random.Random(seed)

    def slot(self) -> int | None:
        """The slot the next item goes to, or None to skip it."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = self._rng.randrange(self.seen)
        return j if j < self.k else None


class KernelTap:
    def __init__(self, hamming, patch, seed: int, traced: bool, k1_samples: int,
                 k2_samples: int):
        self.hamming, self.patch = hamming, patch
        self.traced = traced
        self.k1 = Reservoir(k1_samples, seed * 2 + 1)
        self.k2 = Reservoir(k2_samples, seed * 2 + 2)
        self.k1_sizes: list = []   # traced: (n, m, allowed pairs as a 0-dim device tensor)
        self.k2_sizes: list = []   # traced: (h, w, ys, xs) on the device
        self._lock = threading.Lock()

    def __enter__(self):
        self._k1, self._k2 = self.hamming.masked_top2, self.patch.gather_patches
        k1, k2 = self._k1, self._k2

        def masked_top2(desc_a, desc_b, mask, policy=None):
            out = k1(desc_a, desc_b, mask, policy=policy)
            with self._lock:
                j = self.k1.slot()
                if j is not None:
                    self.k1.items[j] = tuple(x.clone() for x in (desc_a, desc_b, mask, *out))
                if self.traced:
                    self.k1_sizes.append((mask.shape[0], mask.shape[1], mask.sum()))
            return out

        def gather_patches(img, ys, xs):
            out = k2(img, ys, xs)
            with self._lock:
                j = self.k2.slot()
                if j is not None:
                    self.k2.items[j] = tuple(x.clone() for x in (img, ys, xs, out))
                if self.traced:
                    self.k2_sizes.append((img.shape[0], img.shape[1], ys.clone(), xs.clone()))
            return out

        self.hamming.masked_top2, self.patch.gather_patches = masked_top2, gather_patches
        return self

    def __exit__(self, *exc):
        self.hamming.masked_top2, self.patch.gather_patches = self._k1, self._k2
        return False

    def k1_host(self) -> list:
        """(a, b, mask, (idx, best, second)) of each sampled K1 launch, numpy."""
        out = []
        for a, b, mask, *res in self.k1.items:
            out.append((a.cpu().numpy(), b.cpu().numpy(), mask.bool().cpu().numpy(),
                        [r.cpu().numpy() for r in res]))
        return out

    def k2_host(self) -> list:
        return [tuple(x.cpu().numpy() for x in item) for item in self.k2.items]

    def k1_launch_sizes(self) -> list[tuple[int, int, int]]:
        return [(n, m, int(c)) for n, m, c in self.k1_sizes]

    def k2_launch_sizes(self) -> list[tuple[int, int, np.ndarray, np.ndarray]]:
        return [(h, w, ys.cpu().numpy(), xs.cpu().numpy()) for h, w, ys, xs in self.k2_sizes]
