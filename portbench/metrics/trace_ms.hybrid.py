"""trace_ms.hybrid: device ms a hybrid frame inside the trace kernels'
ranges (trace_kernel.*)."""

from portbench import readers


def read(ctx):
    return readers.trace_ms(ctx, "hybrid")
