"""tracking.fused_pose_ms: the window's total of the port's
`track.fused_pose` stage (the projection-search retry ladder with its pose
GN, the BoW fallback and its second ladder where they run, up to the
result's read-back to the host) over the poses returned, in ms per frame."""


def read(rd):
    s = rd.stages.get("track.fused_pose")
    if s is None or not rd.win["poses"]:
        return None
    return s["total_ms"] / rd.win["poses"]
