"""Parallel execution over a list of devices.

Port of steeljax/parallel: the reference is single-GPU/single-queue
(SURVEY.md §2.7); the first-class parallelism is pixel sharding across
devices with the scene replicated (it is read-only per frame) and zero
per-frame collectives.
"""

from steeljax_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, render_frame_sharded, render_hybrid_frame_sharded,
    shard_pixels)
