"""device.idle_pct: 100 x (1 - the union of the device ops' intervals over
the traced window), from the profiler, in %."""


def read(rd):
    if not rd.cuda or rd.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rd.trace.busy_s() / rd.trace.window_s)
