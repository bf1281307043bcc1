"""gbuffer_stage_ms: device span of the gbuffer_stage range a hybrid frame
(first device operation to last)."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "hybrid", "gbuffer_stage")
