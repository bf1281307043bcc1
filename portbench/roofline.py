"""The least time the trace kernels could take, counted from a cell's
shapes and never from the kernels' own telemetry, so it reads the same
work whatever implements the traversal.

Bytes, per frame: each ray the frame needs traced reads its origin,
direction and interval once (32 B) and writes its hit once (16 B); each
trace call reads the scene's triangle vertices once (36 B a triangle).  No
node tables: they belong to the implementation.  The bound is bytes over
the published HBM3 bandwidth of an H100 SXM (NVIDIA's data sheet, at its
700 W power limit); the run prints the card's power limit beside it.
Traversal is latency-bound, so the shares are small, but comparable
across implementations.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
RAY_BYTES = 32 + 16
TRIANGLE_BYTES = 36


def least_bytes(shapes: dict) -> float:
    return (shapes["rays_per_frame"] * RAY_BYTES
            + shapes["traces_per_frame"] * shapes["triangles"]
            * TRIANGLE_BYTES)


def least_ms(shapes: dict) -> float:
    return least_bytes(shapes) / PEAK_BYTES_PER_S * 1000.0
