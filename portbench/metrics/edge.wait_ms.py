"""edge.wait_ms: the mean over the window's replies of the reply delay on
the phone's clock less the server's tracking of that packet (the span
around the `track_features` call `track_edge` makes under the server's
edge lock): the time a packet spends on the wire, being decoded, in its
lane's queue and waiting for its turn at the lock, in ms."""

import numpy as np


def read(rd):
    replies = getattr(rd.cell, "replies", None)
    if not replies:
        return None
    # each track_edge span holds one edge_tracking span of the same client
    spans = rd.spans.records
    inner = {}
    for s in spans:
        if s["name"] != "track_edge":
            continue
        for t in spans:
            if (t["name"] == "edge_tracking" and t["client"] == s["client"]
                    and s["t0"] <= t["t0"] and t["t1"] <= s["t1"]):
                inner[(s["client"], s["frame"])] = t["t1"] - t["t0"]
                break
    ids = [ph.ids for ph in rd.cell.phones]
    waits = [(t_reply - t_send - inner[(pid, int(ids[pid][k]))]) * 1e3
             for pid, k, t_send, t_reply, _ in replies if (pid, int(ids[pid][k])) in inner]
    return (float(np.mean(waits)), {"n": len(waits)}) if waits else None
