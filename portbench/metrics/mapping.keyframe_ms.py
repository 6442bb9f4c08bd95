"""mapping.keyframe_ms: the mean of the port's `track.new_kf` stage (a
keyframe's insertion with its inline local mapping), in ms per keyframe."""


def read(rd):
    s = rd.stages.get("track.new_kf")
    return None if s is None else s["mean_ms"]
