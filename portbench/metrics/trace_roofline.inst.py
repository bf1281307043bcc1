"""trace_roofline.inst: the two-level trace kernels' least time by bytes
(portbench/roofline_inst.py, from the instanced scene's own data) over
trace_ms.inst, in %."""

from portbench import readers, roofline_inst


def read(ctx):
    ms = readers.trace_ms(ctx, "pt_instanced")
    if ms is None or ctx.get("shapes") is None:
        return None
    return 100.0 * roofline_inst.least_ms(ctx["shapes"]) / ms
