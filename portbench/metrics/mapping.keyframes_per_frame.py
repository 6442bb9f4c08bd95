"""mapping.keyframes_per_frame: keyframes made in the window (the active
map's keyframe counter, culled ones included) over the poses returned."""


def read(rd):
    if not rd.win["poses"]:
        return None
    return rd.win["keyframes"] / rd.win["poses"]
