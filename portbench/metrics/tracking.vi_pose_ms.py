"""tracking.vi_pose_ms: the window's total of the port's `track.vi_pose`
stage (the visual-inertial pose refinement) over the poses returned, in
ms per frame."""


def read(rd):
    tot = rd.stage_total_ms("track.vi_pose")
    if tot is None or not rd.win["poses"]:
        return None
    return tot / rd.win["poses"]
