"""trace_ms.inst: device ms a frame of mode pt_instanced inside the trace
kernels' ranges (trace_kernel.K6 and K6_anyhit, the two-level walk)."""

from portbench import readers


def read(ctx):
    return readers.trace_ms(ctx, "pt_instanced")
