"""tracking.vi_pose_replay_pct: the share of the window's visual-inertial
pose solves that replayed a captured CUDA graph (the port's
`track.vi_pose_replay` counter) among those and the solves run eagerly
(`track.vi_pose_eager`), in %. Beside it, `captures`: the graphs captured
in the window (`track.vi_pose_capture`), 0 where the warm-up reached every
shape and variant. A port without the counters reports nothing."""

from harness import program_spans


def read(rd):
    counts = program_spans.counts()
    replays = counts.get("track.vi_pose_replay", 0)
    solves = replays + counts.get("track.vi_pose_eager", 0)
    if not solves:
        return None
    return 100.0 * replays / solves, {"captures": counts.get("track.vi_pose_capture", 0)}
