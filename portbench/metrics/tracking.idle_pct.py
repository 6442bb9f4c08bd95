"""tracking.idle_pct: the share of the union of the port's `track.*` spans
(`track.new_kf` and every span inside it left out: `mapping.idle_pct`'s)
that falls in the device's idle gaps, the spans cut to the traced part of
the window, in %."""

from harness import program_spans


def read(rd):
    spans = program_spans.spans()
    if not rd.cuda or not spans:
        return None
    mapping = program_spans.under(spans, {"track.new_kf"})
    own = [s for s in spans if s.name.startswith("track.") and s.id not in mapping]
    return program_spans.idle_pct(rd.trace, own)
