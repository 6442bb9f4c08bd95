"""tracking.extract_ms: the window's total of the port's `track.extract`
stage over the poses returned, in ms per frame."""


def read(rd):
    tot = rd.stage_total_ms("track.extract")
    if tot is None or not rd.win["poses"]:
        return None
    return tot / rd.win["poses"]
