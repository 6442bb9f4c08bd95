"""mapping.idle_pct: the share of the union of the port's `track.new_kf`
(a keyframe's insertion with its inline local mapping) and `lm.*` spans,
on any thread, that falls in the device's idle gaps, the spans cut to the
traced part of the window, in %."""

from harness import program_spans


def read(rd):
    spans = program_spans.spans()
    if not rd.cuda or not spans:
        return None
    own = [s for s in spans if s.name == "track.new_kf" or s.name.startswith("lm.")]
    return program_spans.idle_pct(rd.trace, own)
