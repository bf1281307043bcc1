"""The least time of the trace kernels over the two-level structure,
counted from the instanced scene's own data and never from the program's
tables or the kernels' telemetry.

Bytes, per frame: each ray the frame needs traced reads its origin,
direction and interval once (32 B) and writes its hit once (16 B); each
trace call reads the triangles of the distinct meshes once (36 B a
triangle) and each instance's 3x4 transform once (48 B).  On the sunlit
scene: 1,038 triangles (a quad, a box, a sphere) and 310 instances, 52,248
B a trace call.  No node tables: they belong to the implementation.  The
bound is bytes over the published HBM3 bandwidth of an H100 SXM, as
`roofline.py`'s.
"""

from __future__ import annotations

from portbench.roofline import PEAK_BYTES_PER_S, RAY_BYTES, TRIANGLE_BYTES

TRANSFORM_BYTES = 48


def scene_shapes(arrays) -> dict:
    """What the count reads of a generator's `SceneArrays`: the triangles
    of the distinct meshes the entities use and the instances (render
    objects)."""
    used = {m for e in arrays.entities for m, _ in e.objects}
    return {"distinct_triangles": sum(len(arrays.meshes[m].indices) // 3
                                      for m in used),
            "instances": sum(len(e.objects) for e in arrays.entities)}


def trace_bytes(shapes: dict) -> float:
    """Bytes one trace call reads of the scene."""
    return (shapes["distinct_triangles"] * TRIANGLE_BYTES
            + shapes["instances"] * TRANSFORM_BYTES)


def least_bytes(shapes: dict) -> float:
    return (shapes["rays_per_frame"] * RAY_BYTES
            + shapes["traces_per_frame"] * trace_bytes(shapes))


def least_ms(shapes: dict) -> float:
    return least_bytes(shapes) / PEAK_BYTES_PER_S * 1000.0
