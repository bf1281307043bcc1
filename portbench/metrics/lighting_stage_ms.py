"""lighting_stage_ms: device span of the lighting_stage range a hybrid frame
(first device operation to last)."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "hybrid", "lighting_stage")
