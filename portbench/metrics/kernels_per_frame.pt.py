"""kernels_per_frame.pt: device kernels a path-traced frame (profiler
count; copies and fills not counted): the host's launch load."""

from portbench import readers


def read(ctx):
    prof = readers.profiled(ctx, "pt")
    return None if prof is None else prof["kernels"]
