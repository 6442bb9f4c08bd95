"""The yardstick of the port's benchmark: what a later change to the port
may not edit. Traffic generation, the reduction of spans, counters and
profiler events to metrics, the table of peaks, the kernels' operation and
byte counts, and the plain reference that decides `correct`.

Nothing here imports JAX or the JAX package, and only `port.py` reaches
the port (`orbslam3_tpu_torch`), inside its functions: the system under
test, its stage timers and counters, and its kernels' entry points.
"""
