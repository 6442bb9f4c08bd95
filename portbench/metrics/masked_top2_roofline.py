"""masked_top2_roofline: K1 (`masked_top2_kernel`) over the traced part of
the window: the sum of its launches' least times
(`harness.yardstick.k1_least_s`, each launch's sizes and allowed pairs
from the traced run's tap) over the sum of its device times from the
profiler's kernel events, in %."""

from harness import yardstick


def read(rd):
    if not rd.cuda or not rd.k1_sizes:
        return None
    dev_s, n = rd.trace.kernel_s("masked_top2_kernel")
    if not n or dev_s <= 0:
        return None
    least = sum(yardstick.k1_least_s(*s) for s in rd.k1_sizes)
    return 100.0 * least / dev_s, {"launches": n}
