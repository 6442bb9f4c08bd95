"""edge.lock_wait_ms: the mean wait of a tracked packet for the server's
edge lock, in ms, with the count of packets: the port's `edge.lock_wait`
stage (from the entry into `Slam.track_edge` until it holds the lock) less
the stages inside it (the packet's `edge.features`), over the window. Two
lanes taking strict turns wait about one pose of the other lane. A port
without the stage reports nothing."""

import numpy as np

from harness import program_spans


def read(rd):
    spans = program_spans.spans()
    waits = program_spans.self_ns(spans, "edge.lock_wait") if spans else []
    if not waits:
        return None
    return float(np.mean(waits)) * 1e-6, {"n": len(waits)}
