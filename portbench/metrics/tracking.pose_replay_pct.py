"""tracking.pose_replay_pct: the share of the window's retry-ladder
attempts (`engine/track_program.py:fused_track_pose`) that replayed their
captured CUDA graphs (the port's `track.pose_replay` counter) among those
and the attempts run eagerly (`track.pose_eager`), in %. Beside it,
`captures`: the graph pairs captured in the window (`track.pose_capture`),
0 where the warm-up reached every shape. A port without the counters
reports nothing."""

from harness import program_spans


def read(rd):
    counts = program_spans.counts()
    replays = counts.get("track.pose_replay", 0)
    attempts = replays + counts.get("track.pose_eager", 0)
    if not attempts:
        return None
    return 100.0 * replays / attempts, {"captures": counts.get("track.pose_capture", 0)}
