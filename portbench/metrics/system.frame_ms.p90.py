"""system.frame_ms.p90: the 90th percentile of the benchmark's span around
each frame's work in `Slam` in the window, in ms, with the count of
samples: the `track_monocular` call; in the edge cell the `track_features`
call that `track_edge` makes in its turn at the server's edge lock (the
turn's wait is `edge.wait_ms`'s)."""

import numpy as np


def read(rd):
    t0 = rd.win["t0"]
    ms = [(s["t1"] - s["t0"]) * 1e3 for s in rd.spans.records
          if s["name"] in ("track_monocular", "edge_tracking") and s["t0"] >= t0]
    if not ms:
        return None
    return float(np.percentile(ms, 90)), {"n": len(ms)}
