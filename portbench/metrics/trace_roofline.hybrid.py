"""trace_roofline.hybrid: the trace kernels' least time by bytes
(portbench/roofline.py) over trace_ms.hybrid, in %."""

from portbench import readers


def read(ctx):
    return readers.trace_roofline(ctx, "hybrid")
