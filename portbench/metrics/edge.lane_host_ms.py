"""edge.lane_host_ms: the host work of the edge lanes per tracked packet,
in ms: the window's `edge.decode` stages (the C++ codec's parse of every
packet received, skipped ones too) and `edge.features` stages (a tracked
packet's arrays to padded features on the device), summed, over the
tracked packets (the `edge.features` stages), with both counts. A port
without the stages reports nothing."""

from harness import program_spans


def read(rd):
    spans = program_spans.spans() or []
    decode = [s for s in spans if s.name == "edge.decode"]
    features = [s for s in spans if s.name == "edge.features"]
    if not features:
        return None
    total = sum(s.end_ns - s.start_ns for s in decode + features)
    return total * 1e-6 / len(features), {"n": len(features), "decoded": len(decode)}
