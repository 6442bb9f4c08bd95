"""system.unstaged_ms: the mean self time of the port's `slam.frame` spans
in the window (each frame's call into `Slam`: its duration less the part
its child stages cover), in ms, with the count of frames: the work of a
frame that no stage names."""

import numpy as np

from harness import program_spans


def read(rd):
    spans = program_spans.spans()
    own = program_spans.self_ns(spans, "slam.frame") if spans else []
    if not own:
        return None
    return float(np.mean(own)) * 1e-6, {"n": len(own)}
