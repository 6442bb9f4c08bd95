"""tracking.local_map_ms: the window's total of the port's
`track.local_map` stage (the local keyframes' candidate points gathered
and uploaded to the card under the map lock, the wait for the lock
included) over the poses returned, in ms per frame."""


def read(rd):
    s = rd.stages.get("track.local_map")
    if s is None or not rd.win["poses"]:
        return None
    return s["total_ms"] / rd.win["poses"]
