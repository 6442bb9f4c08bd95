"""gather_patches_roofline: K2 (`gather_patches_kernel`) over the traced
part of the window: the sum of its launches' least times
(`harness.yardstick.k2_least_s`) over the sum of its device times from the
profiler's kernel events, in %."""

from harness import yardstick


def read(rd):
    if not rd.cuda or not rd.k2_sizes:
        return None
    dev_s, n = rd.trace.kernel_s("gather_patches_kernel")
    if not n or dev_s <= 0:
        return None
    least = sum(yardstick.k2_least_s(h, w, ys, xs) for h, w, ys, xs in rd.k2_sizes)
    return 100.0 * least / dev_s, {"launches": n}
