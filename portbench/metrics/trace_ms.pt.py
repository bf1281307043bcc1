"""trace_ms.pt: device ms a path-traced frame inside the trace kernels'
ranges (trace_kernel.*)."""

from portbench import readers


def read(ctx):
    return readers.trace_ms(ctx, "pt")
