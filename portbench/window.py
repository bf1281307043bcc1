"""The measured window: frames queued back to back with a bounded number in
flight, as a renderer with vsync off runs behind its swapchain.

Before frame n is queued the host waits on frame n - `in_flight`'s end
event; the window stops queueing once `seconds` have passed on the host
clock and ends in `torch.cuda.synchronize()`.  A frame's time is the
interval between its end event and the previous frame's (the first frame's
from an event recorded as the window opens), on the CUDA events' clock.
"""

from __future__ import annotations

import time


def run(step, seconds: float, in_flight: int, torch,
        min_frames: int = 1) -> dict:
    """Drive `step(n)` for n = 0, 1, ... until `seconds` have passed and at
    least `min_frames` frames were queued.  Returns {"frames", "wall_s",
    "frame_ms": [...]}."""
    cuda = torch.cuda
    start = cuda.Event(enable_timing=True)
    ends = []
    cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    n = 0
    while True:
        if n >= in_flight:
            ends[n - in_flight].synchronize()
        if n >= min_frames and time.perf_counter() - t0 >= seconds:
            break
        step(n)
        end = cuda.Event(enable_timing=True)
        end.record()
        ends.append(end)
        n += 1
    cuda.synchronize()
    wall = time.perf_counter() - t0
    marks = [start] + ends
    frame_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    return {"frames": n, "wall_s": wall, "frame_ms": frame_ms}
