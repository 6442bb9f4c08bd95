"""Asynchronous mapping back end: local mapping and loop closing on a
worker thread, fed by a keyframe queue, with an abortable local BA.

Port of `orbslam3_tpu/engine/async_engine.py` (ORB-SLAM3's LocalMapping and
LoopClosing threads, its keyframe queue and `mbAbortBA`): tracking inserts
a keyframe and returns at once; the worker drains the queue and asks an
in-flight local BA to yield while more keyframes wait; loop detection runs
after each keyframe on the same worker, so the tracking thread never
blocks on mapping.

Consistency across stages uses the map's mutex (`MapState.lock`, the
reference's mMutexMapUpdate), held by the worker around its map mutations
and by the tracker around multi-array reads. Both threads launch kernels
on the default stream of the card (the wrappers take
`torch.cuda.current_stream()`), so their launches serialize there.
"""

from __future__ import annotations

import threading
import time
from collections import deque


class AsyncBackend:
    """A worker thread draining a keyframe queue through `process_fn`.

    `process_fn(k, abort)` is the whole back-end iteration of a keyframe
    (local mapping, loop closing, the system's hooks); `abort` is a nullary
    callable that turns true while more keyframes are waiting."""

    def __init__(self, process_fn):
        self.process_fn = process_fn
        self._queue: deque[int] = deque()
        self._cv = threading.Condition()
        self._abort_ba = False
        self._stop = False
        self._busy = False
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True, name="local-mapping")
        self._thread.start()

    # ------------------------------------------------------------ producer
    def insert_keyframe(self, k: int):
        """`LocalMapping::InsertKeyFrame`: enqueue, and raise the abort flag
        so that a BA in flight yields."""
        with self._cv:
            self._queue.append(int(k))
            self._abort_ba = True
            self._cv.notify()

    def queue_len(self) -> int:
        with self._cv:
            return len(self._queue)

    def flush(self, timeout: float = 120.0):
        """Block until the queue is drained and the worker is idle."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            with self._cv:
                if not self._queue and not self._busy:
                    return
            time.sleep(0.005)
        raise TimeoutError("async backend did not drain")

    def shutdown(self, timeout: float = 30.0):
        """Stop the worker after the queue drains; re-raise its first error."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=timeout)
        if self._errors:
            raise self._errors[0]

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def errors(self):
        return list(self._errors)

    # ------------------------------------------------------------ consumer
    def _abort_requested(self) -> bool:
        with self._cv:
            return self._abort_ba

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.2)
                if self._stop and not self._queue:
                    return
                k = self._queue.popleft()
                # abort only while more keyframes wait behind this one
                self._abort_ba = bool(self._queue)
                self._busy = True
            try:
                self.process_fn(k, self._abort_requested)
            except Exception as e:  # keep the worker alive; surfaced by shutdown
                self._errors.append(e)
            finally:
                with self._cv:
                    self._busy = False
