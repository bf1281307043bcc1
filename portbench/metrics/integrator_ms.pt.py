"""integrator_ms.pt: device ms a path-traced frame outside the trace kernels'
ranges (trace_kernel.*)."""

from portbench import readers


def read(ctx):
    prof = readers.profiled(ctx, "pt")
    if prof is None:
        return None
    return prof["busy_ms"] - prof["trace_ms"]
