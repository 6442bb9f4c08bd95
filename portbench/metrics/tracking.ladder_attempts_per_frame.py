"""tracking.ladder_attempts_per_frame: the port's `track.ladder_attempt`
counter (one projection search plus one pose GN of the retry ladder, each
with a host read) over the window over the poses returned."""

from harness import program_spans


def read(rd):
    n = program_spans.counts().get("track.ladder_attempt")
    if n is None or not rd.win["poses"]:
        return None
    return n / rd.win["poses"]
