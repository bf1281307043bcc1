"""Acceleration structures: BVH build and traversal.

Port of steeljax/accel/__init__.py: the package exports the reference's
BVH walk (accel.traverse), the CPU oracle every trace kernel is held
against; the kernels' wrappers are in accel.cuda_traverse and
accel.dispatch.
"""

from steeljax_torch.accel.traverse import (  # noqa: F401
    trace_any, trace_nearest, trace_nearest_brute)
