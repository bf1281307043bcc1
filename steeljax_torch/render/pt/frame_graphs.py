"""Path-traced frames replayed as CUDA graphs (integrator.render_pixels).

A path-traced frame never reads a device value on the host (see the
integrator's docstring): which kernels it launches, and in which order,
depends only on what the host knows before the frame.  So on a CUDA device
each kind of frame is captured once as a CUDA graph and then replayed: one
launch from the host in place of thousands (2,634 a frame on the sunlit
benchmark scene), the same kernels in the same order, so a replayed frame
is bit-equal to an eager one.

`FrameGraphs.run` takes a frame by its key, which holds everything the
capture bakes in (integrator._frame_key).  For each key:

- the first frame runs eagerly, which also loads every kernel it launches;
- the second is captured, then replayed ("capture");
- every later one writes what changes into the fixed buffers the graph
  reads (`FrameInputs`: the seed words, the camera matrices and the pixels)
  and replays ("replay").

A capture that raises (a frame that reads the device on the host, which no
frame of the CUDA paths does) leaves its key eager from then on.  The
host's launch counters (COUNTERS) count what the host launched: a capture
adds its frame's launches once, a replay nothing.  While a profiler
collects, frames run eagerly, so that the profiler sees their launches and
their ranges.  A device keeps at most GRAPHS_PER_DEVICE graphs, the least
recently used going first, and a graph goes as soon as the scene or the
tables it reads go.  The frame's row in core.profiling's record says how it
ran.  A replay's outputs are the graph's own buffers, which the next replay
overwrites, so the caller gets copies.  A frame whose capturer takes no
device (`Eager`, or CudaGraphs off a CUDA device) runs eagerly every time.
"""

from __future__ import annotations

import collections
import weakref

import numpy as np
import torch

from steeljax_torch.accel import cuda_traverse, treelets
from steeljax_torch.core import profiling
from steeljax_torch.render import surface
from steeljax_torch.render.pt import stages

# Graphs kept a device; each holds a frame's intermediates in its memory
# pool.
GRAPHS_PER_DEVICE = 2
# Keys kept without a graph (seen once, or whose capture raised).
KEYS_KEPT = 16
# The host counters a frame's launches add to.
COUNTERS = (cuda_traverse.LAUNCHES, treelets.SCHEDULER, stages.LAUNCHES,
            surface.COUNTS)


class CudaGraphs:
    """The capturer of CUDA devices: a torch.cuda.CUDAGraph, captured on
    one side stream a device."""

    def __init__(self):
        self._streams = {}

    def accepts(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def capture(self, fn, device: torch.device):
        """Capture the launches of fn() without running them.  Returns
        (replay, outputs): outputs are fn()'s tensors, which every replay()
        rewrites in place on the current stream."""
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), \
                torch.cuda.graph(graph, stream=stream):
            outputs = fn()
        return graph.replay, outputs


class Eager:
    """A capturer that takes no device: every frame runs as the host
    launches it, for a caller that times or compares eager frames or
    replaces a function the frame calls."""

    def accepts(self, device: torch.device) -> bool:
        return False


class FrameInputs:
    """What changes between the frames of one key: the seed words, one a
    sample (rng.seed_word), the matrices (host arrays or tensors, float32
    on the device) and the pixels (tensors, int64 on the device).
    `new(device)` puts them in new device tensors, `write(buffers)` into
    the buffers of a graph; host matrices go through pinned memory, so no
    copy waits on the card."""

    def __init__(self, words, matrices, pixels):
        self.words = list(words)
        self.arrays = ([(m, torch.float32) for m in matrices]
                       + [(p, torch.int64) for p in pixels])

    def new(self, device) -> tuple:
        buffers = [torch.empty((len(self.words),), dtype=torch.int64,
                               device=device)]
        for a, dtype in self.arrays:
            shape = a.shape if isinstance(a, torch.Tensor) else np.shape(a)
            buffers.append(torch.empty(tuple(shape), dtype=dtype,
                                       device=device))
        self.write(buffers)
        return tuple(buffers)

    def write(self, buffers) -> None:
        words, *arrays = buffers
        for i, word in enumerate(self.words):
            words[i].fill_(word)
        for buffer, (a, _) in zip(arrays, self.arrays):
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a, np.float32))
                if buffer.is_cuda:
                    a = a.pin_memory()
            buffer.copy_(a, non_blocking=True)


class _Entry:
    """A key's state: "seen" (its first frame ran), "failed" (its capture
    raised) or "graph"; the weak references to what it reads; with a graph,
    the replay, the buffers it reads, the outputs it writes and the layout
    of the outputs (frame's own)."""

    __slots__ = ("state", "refs", "device", "replay", "buffers", "outputs",
                 "layout")

    def __init__(self, state: str):
        self.state = state


class FrameGraphs:
    """The frames' graphs of one process, captured by `capturer` (CudaGraphs,
    or a stand-in in the CPU tests) on the devices it accepts."""

    def __init__(self, capturer):
        self.capturer = capturer
        self._entries = collections.OrderedDict()   # least recent first

    def graphs(self) -> int:
        return sum(e.state == "graph" for e in self._entries.values())

    def run(self, key, owners, device: torch.device, frame,
            inputs: FrameInputs):
        """This frame of `key`: `frame(buffers)` does its work on device
        buffers like `inputs.new(device)`'s and returns (tensors, layout),
        layout plain data that says what the tensors are.  `owners` are what
        the frame reads and a graph must not outlive (the scene and the
        tables).  Returns (tensors, layout), the tensors the caller's
        own."""
        if not self.capturer.accepts(device):
            return frame(inputs.new(device))
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        if torch.autograd._profiler_enabled() or (
                entry is not None and entry.state == "failed"):
            return frame(inputs.new(device))
        if entry is None:
            out = frame(inputs.new(device))
            self._remember(key, owners, _Entry("seen"))
            return out
        if entry.state == "seen":
            return self._capture(entry, device, frame, inputs)
        inputs.write(entry.buffers)
        entry.replay()
        profiling.frame_ran("replay")
        return [t.clone() for t in entry.outputs], entry.layout

    def _capture(self, entry, device, frame, inputs):
        self._evict(device)
        buffers = inputs.new(device)
        layouts = []

        def body():
            tensors, layout = frame(buffers)
            layouts.append(layout)
            return tensors

        # A capture that raises launched nothing: its counts go.
        before = [dict(counter) for counter in COUNTERS]
        try:
            replay, outputs = self.capturer.capture(body, device)
        except RuntimeError:
            for counter, counts in zip(COUNTERS, before):
                counter.update(counts)
            entry.state = "failed"
            return frame(inputs.new(device))
        entry.state = "graph"
        entry.device = device
        entry.replay = replay
        entry.buffers = buffers
        entry.outputs = outputs
        entry.layout = layouts[0]
        replay()
        profiling.frame_ran("capture")
        return [t.clone() for t in outputs], entry.layout

    def _remember(self, key, owners, entry: _Entry) -> None:
        def drop(_, key=key):
            self._entries.pop(key, None)

        entry.refs = tuple(weakref.ref(owner, drop) for owner in owners)
        self._entries[key] = entry
        spare = [k for k, e in self._entries.items() if e.state != "graph"]
        for k in spare[:max(len(spare) - KEYS_KEPT, 0)]:
            del self._entries[k]

    def _evict(self, device) -> None:
        """Make room for one more graph on `device`."""
        held = [k for k, e in self._entries.items()
                if e.state == "graph" and e.device == device]
        for k in held[:max(len(held) - GRAPHS_PER_DEVICE + 1, 0)]:
            del self._entries[k]
