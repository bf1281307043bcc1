"""The roofline's byte count and the traced stretch's reduction, on fixed
inputs: both repeat exactly."""

from __future__ import annotations

import types

from portbench import readers, roofline, traced


def test_least_bytes_repeat_exactly():
    shapes = {"rays_per_frame": 3_000_000.0, "traces_per_frame": 8,
              "triangles": 1_000_002}
    assert roofline.least_bytes(shapes) == 3_000_000 * 48 \
        + 8 * 1_000_002 * 36
    assert roofline.least_bytes(shapes) == roofline.least_bytes(
        dict(shapes))
    ms = roofline.least_ms(shapes)
    assert ms == roofline.least_bytes(shapes) / 3.35e12 * 1000.0


def _event(name, start, end, device, annotation=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_reduce_counts_busy_ranges_and_gaps():
    events = [
        _event("alpha8_kernel", 0.0, 100.0, True),
        _event("gather", 90.0, 150.0, True),          # overlaps: union 150
        _event("Memcpy HtoD (Pageable -> Device)", 400.0, 450.0, True),
        _event("trace_kernel.K4", 0.0, 100.0, True, annotation=True),
        _event("lighting_stage", 90.0, 450.0, True, annotation=True),
        _event("aten::nonzero", 140.0, 420.0, False),
        _event("cudaStreamSynchronize", 200.0, 390.0, False),
    ]
    prof = traced.reduce(events, wall_s=1e-3, frames=2,
                         spans=("lighting_stage",))
    assert prof["busy_ms"] == (150.0 + 50.0) / 1000.0 / 2
    assert prof["kernels"] == 1.0
    assert prof["trace_ms"] == 100.0 / 1000.0 / 2
    assert prof["span_ms"] == {"lighting_stage": 360.0 / 1000.0 / 2}
    assert prof["busy_s"] == 200.0 / 1e6
    assert prof["idle_gaps"] == [("cudaStreamSynchronize", 250.0 / 1e6)]
    assert prof["device_ops"][0] == ("alpha8_kernel", 100.0 / 1e6)


def test_readers_leave_out_what_they_cannot_read():
    ctx = {"mode": "pt", "window": {"frames": 10, "wall_s": 2.0},
           "profile": {"busy_ms": 150.0, "trace_ms": 0.0, "wall_ms": 400.0,
                       "span_ms": {}}, "shapes": None}
    assert readers.trace_ms(ctx, "pt") is None
    assert readers.trace_roofline(ctx, "pt") is None
    assert readers.device_idle_pct(ctx, "pt") == 100.0 * (1 - 150.0 / 200.0)
    assert readers.device_idle_pct(ctx, "hybrid") is None
