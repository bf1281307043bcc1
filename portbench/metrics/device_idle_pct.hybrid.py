"""device_idle_pct.hybrid: 1 - device busy a hybrid frame (the traced
stretch) / wall a frame (the run's untraced window), in %."""

from portbench import readers


def read(ctx):
    return readers.device_idle_pct(ctx, "hybrid")
