"""loop.keyframe_ms: the window's total of the port's loop-closing stages
(`lc.*`) over the keyframes made in it, in ms per keyframe."""


def read(rd):
    tot = rd.stage_total_ms("lc.")
    if tot is None or not rd.win["keyframes"]:
        return None
    return tot / rd.win["keyframes"]
