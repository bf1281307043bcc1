"""trace_roofline.pt: the trace kernels' least time by bytes
(portbench/roofline.py) over trace_ms.pt, in %."""

from portbench import readers


def read(ctx):
    return readers.trace_roofline(ctx, "pt")
