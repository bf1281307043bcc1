"""Tracing and profiling hooks: the port's spans, their in-memory record and
the Chrome-trace exporter.

Port of steeljax/core/profiling.py.  The reference engine embeds
easy_profiler blocks (main.cpp:5-6); here `named_scope(name)` is the one
span helper.  Every span reads the host clock (time.perf_counter_ns) at its
entry and exit into the process's record; while a torch profiler collects
(torch.autograd._profiler_enabled()), it also enters
torch.profiler.record_function(name), so the span lies on the profiler's
timeline over the kernels it launched.  When none collects it enters no
range, records no CUDA event and launches nothing: one to two
microseconds of host time a span.

- `frame(name)` is the outermost span of one frame (nested frames count
  once).  Each frame closes one row of the record: its host ms, the host ms
  inside its `wait=True` spans (calls that wait on the card: a blocking
  copy between host and device, a read of a device value), its host ms by
  span name (inclusive and self, self being a span less its children),
  whether a profiler collected during it and how it ran (`frame_ran`:
  "eager" unless the frame says it replayed or captured a CUDA graph).
  The record keeps the last ROW_LIMIT rows; `record()` returns them with
  the per-name totals of every span since `reset()`, set-up steps outside
  frames included.
- `frame_ran(how)` says how the open frame ran: "replay" (a CUDA graph's
  replay, no launch from the host), "capture" (the graph captured, then
  replayed) or "eager".
- `count(name, amount)` adds to a counter of the open frame's row (the
  row's "counters"; outside a frame, to nothing): `instances.in_place` or
  `instances.rebuilt` and `instances.upload_bytes` on the rows of
  `instances.refresh`, the instanced tables' per-frame refresh;
  `integrator.bounces` and `integrator.stage_bounces` (those whose stages
  ran as the kernels of csrc/pathstage.cu) on every row of
  `integrator.render_pixels`, replayed frames' too.
- `count_retrace(counts, rows)` keeps, in the open frame's row, references
  to the bounded alpha re-trace's pending counts (0-d device tensors taken
  by the integrator anyway); `record()` sums them once, on request, for the
  last frame no profiler saw: no kernel and no host read in the frame.
- `named_scope(name, sync=device)` ends a set-up step in
  torch.cuda.synchronize() on a CUDA device, so that its seconds are its
  own.  Frame spans never synchronize.
- `trace(log_dir)` profiles its body and writes a Chrome trace
  (`render_cli --profile DIR`; open it in Perfetto or chrome://tracing)
  and, beside it, `record()` as `record.<pid>.json`.

Which reader takes which span: portbench's per-layer metrics read the
record (`host_frame_ms.*` the frame rows, `host_wait_ms.pt` the waits,
`retrace_live_pct.pt` the re-trace counts, `graph_frames_pct.pt` and
`graph_frames_pct.inst` how the frames ran, `stage_kernel_pct.pt` and
`stage_kernel_pct.inst` the frames' bounce counters, `refresh_ms.inst` the
`instances.refresh` rows, `prepare_tables_s` the
`dispatch.prepare_tables` total, `environment_s` the `environment.load`
total) and the device span of `gbuffer_stage` and `lighting_stage` from
the profiler.  Every other span
(the integrator's bounce pieces, the hybrid stages' pieces, the set-up
steps inside prepare_scene and load_environment) is read by an operator in
the exported trace and record.  The record is the rendering thread's:
spans are not meant to be entered from several threads at once.  There is
no live profiling endpoint.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# Frame rows kept: the oldest go first.
ROW_LIMIT = 8192

_clock = time.perf_counter_ns
_collecting = torch.autograd._profiler_enabled


class _Record:
    """The spans' record.  `spans` is where a closing span adds its calls,
    host ns and self ns under its name: the open frame's own dict, else
    `outside`'s.  A frame's row is (name, ns, wait ns, spans, profiled,
    re-trace counts, how it ran)."""

    def __init__(self):
        self.outside = {}
        self.evicted = {}           # the totals of rows that went
        self.rows = collections.deque()
        self.top = None             # the innermost open span
        self.frame = None           # the open frame's span
        self.spans = self.outside
        self.wait_ns = 0
        self.waiting = 0            # open wait spans
        self.profiled = False
        self.retrace = None
        self.retrace_row = None     # the last unprofiled row with counts
        self.ran = "eager"
        self.counters = None


_RECORD = _Record()


def reset() -> None:
    """Forget every row and total; the spans open now close into the new
    record (outside any frame)."""
    global _RECORD
    top = _RECORD.top
    _RECORD = _Record()
    _RECORD.top = top


def _add(into: dict, spans: dict) -> None:
    for name, (calls, ns, own) in spans.items():
        total = into.setdefault(name, [0, 0, 0])
        total[0] += calls
        total[1] += ns
        total[2] += own


class named_scope:
    """A span named `name` (the EASY_BLOCK analog), as a context manager.
    `wait=True` marks a call that waits on the card: its host time also
    counts as the open frame's wait.  `sync` (a device) ends the span in a
    synchronize on a CUDA device: for set-up steps that launch device work,
    never for a frame's."""

    __slots__ = ("name", "wait", "sync", "parent", "child", "start",
                 "range")

    def __init__(self, name: str, wait: bool = False, sync=None):
        self.name = name
        self.wait = wait
        self.sync = sync

    def __enter__(self):
        rec = _RECORD
        if _collecting():
            self.range = record_function(self.name)
            self.range.__enter__()
            rec.profiled = True
        else:
            self.range = None
        if self.wait:
            rec.waiting += 1
        self.parent = rec.top
        rec.top = self
        self.child = 0
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            device = torch.device(self.sync)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        elapsed = _clock() - self.start
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = _RECORD
        parent = rec.top = self.parent
        if parent is not None:
            parent.child += elapsed
        own = elapsed - self.child
        total = rec.spans.get(self.name)
        if total is None:
            rec.spans[self.name] = [1, elapsed, own]
        else:
            total[0] += 1
            total[1] += elapsed
            total[2] += own
        if self.wait:
            rec.waiting -= 1
            if rec.waiting == 0:
                rec.wait_ns += elapsed
        return False


class frame(named_scope):
    """The outermost span of one frame, which closes one row of the
    record; inside an open frame, a span."""

    __slots__ = ("owns",)

    def __init__(self, name: str):
        super().__init__(name)

    def __enter__(self):
        rec = _RECORD
        self.owns = rec.frame is None
        if self.owns:
            rec.frame = self
            rec.spans = {}
            rec.wait_ns = 0
            rec.profiled = False
            rec.retrace = None
            rec.ran = "eager"
            rec.counters = None
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self.owns:
            rec = _RECORD
            profiled = rec.profiled or _collecting()
            retrace = None if profiled else rec.retrace
            row = [self.name, rec.spans[self.name][1], rec.wait_ns,
                   rec.spans, profiled, retrace, rec.ran, rec.counters]
            if len(rec.rows) == ROW_LIMIT:
                _add(rec.evicted, rec.rows.popleft()[3])
            rec.rows.append(row)
            if retrace is not None:
                if rec.retrace_row is not None:
                    rec.retrace_row[5] = None
                rec.retrace_row = row
            rec.frame = rec.retrace = None
            rec.spans = rec.outside
        return False


def upload(x, name: str, *, device, dtype=None) -> torch.Tensor:
    """torch.as_tensor(x, dtype=dtype, device=device); where `x` is not
    already a tensor, inside a wait span named `name`: a copy of host data
    to a CUDA device waits for the work queued before it."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    with named_scope(name, wait=True):
        return torch.as_tensor(x, dtype=dtype, device=device)


def frame_ran(how: str) -> None:
    """Say how the open frame ran: "replay", "capture" or "eager" (every
    frame's default); nothing outside a frame."""
    rec = _RECORD
    if rec.frame is not None:
        rec.ran = how


def count(name: str, amount: int = 1) -> None:
    """Add `amount` to the open frame's counter `name`; nothing outside a
    frame."""
    rec = _RECORD
    if rec.frame is not None:
        if rec.counters is None:
            rec.counters = {}
        rec.counters[name] = rec.counters.get(name, 0) + amount


def count_retrace(counts: list, rows: int) -> None:
    """Keep the pending counts entering an alpha re-trace's passes (0-d
    device tensors, one a pass, each pass launched over `rows` rays) in the
    open frame's row; nothing outside a frame."""
    rec = _RECORD
    if rec.frame is not None and counts:
        if rec.retrace is None:
            rec.retrace = []
        rec.retrace.append((list(counts), rows))


def _ms(ns: int) -> float:
    return ns / 1e6


def record() -> dict:
    """The record as plain data: {"rows": [{"frame", "ms", "wait_ms",
    "spans" {name: ms}, "self_ms" {name: ms}, "profiled", "ran", and
    "counters" {name: amount} where the frame counted} ...],
    "totals": {name: {"calls", "ms", "self_ms"}}}, totals of every span
    closed since `reset()`.  The last frame no profiler saw whose traces
    re-traced also has "retrace": {"pending", "slots"}, the pending rays
    entering its re-trace passes and the rays the passes were launched
    over, summed over its alpha traces."""
    rec = _RECORD
    held = rec.retrace_row
    if held is not None and isinstance(held[5], list):
        pending = torch.stack([c for counts, _ in held[5] for c in counts])
        held[5] = {"pending": int(pending.sum()),
                   "slots": sum(len(counts) * rows
                                for counts, rows in held[5])}
    rows = []
    totals = {}
    _add(totals, rec.evicted)
    _add(totals, rec.outside)
    for name, ns, wait_ns, spans, profiled, retrace, ran, counters \
            in rec.rows:
        _add(totals, spans)
        out = {"frame": name, "ms": _ms(ns), "wait_ms": _ms(wait_ns),
               "spans": {k: _ms(v[1]) for k, v in spans.items()},
               "self_ms": {k: _ms(v[2]) for k, v in spans.items()},
               "profiled": profiled, "ran": ran}
        if isinstance(retrace, dict):
            out["retrace"] = dict(retrace)
        if counters:
            out["counters"] = dict(counters)
        rows.append(out)
    return {"rows": rows,
            "totals": {name: {"calls": calls, "ms": _ms(ns),
                              "self_ms": _ms(own)}
                       for name, (calls, ns, own) in totals.items()}}


def start_profiler_server(port: int = 9012):
    """The reference's live endpoint (jax.profiler.start_server) has no
    counterpart here: torch.profiler attaches to no running process without
    an external daemon, which the card's machine does not have."""
    raise NotImplementedError(
        "no live profiling endpoint in the PyTorch port: capture a trace "
        "with core.profiling.trace(log_dir) (render_cli --profile DIR)")


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the body and write `<log_dir>/render.<pid>.pt.trace.json`
    and the record (`record()`) as `<log_dir>/record.<pid>.json` when it
    ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / f"render.{os.getpid()}"
                                 ".pt.trace.json"))
    (log_dir / f"record.{os.getpid()}.json").write_text(
        json.dumps(record()))


class FrameTimer:
    """The ImGui frame-time overlay's data source
    (UIRenderer.cpp:108-112): exponential moving average of frame time."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self._last = None
        self.frame_time = 0.0

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.frame_time = (self.smoothing * self.frame_time
                               + (1.0 - self.smoothing) * dt
                               if self.frame_time else dt)
        self._last = now
        return self.frame_time

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time if self.frame_time else 0.0

    def overlay_text(self) -> str:
        return (f"Frame time: {self.frame_time * 1e3:.2f} ms "
                f"({self.fps:.1f} FPS)")
