"""edge.reply_ms.p90: the 90th percentile, on the phones' clock, of the
time from a packet's send to its pose reply, over the window's packets,
in ms, with the count of samples."""

import numpy as np


def read(rd):
    replies = getattr(rd.cell, "replies", None)
    if not replies:
        return None
    ms = [(t_reply - t_send) * 1e3 for _, _, t_send, t_reply, _ in replies]
    return float(np.percentile(ms, 90)), {"n": len(ms)}
