"""device_idle_pct.pt: 1 - device busy a path-traced frame (the traced
stretch) / wall a frame (the run's untraced window), in %."""

from portbench import readers


def read(ctx):
    return readers.device_idle_pct(ctx, "pt")
