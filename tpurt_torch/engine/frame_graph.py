"""render()'s static frame as one CUDA graph, captured once and replayed.

Eager PyTorch enqueues a frame as some 400 launches from the host, which
at 1080p take the host longer than the card takes to run them. A replay
enqueues the recorded frame as one graph launch.

``FrameGraph.frame(inputs, noise, body)`` runs body(noise), a frame of
``engine/frame.render_frame`` whose GTAO noise maps are `noise`. `inputs`
is what else the body reads: its arguments and the module switches it
reads at call time, keyed by ``frame_key`` (every tensor by address,
shape, strides and dtype, every other value as it is). A frame whose key
differs from the last one's runs
eagerly, so lazy initialisation (the kernel library, the noise maps)
stays out of the graph; the next frame with the same key captures the
body and replays it, and every frame after that replays it. Before each
replay the frame's noise maps are copied into the buffer the graph reads
(one device-to-device copy); the camera, light and GTAO-constant tensors
are updated in place by the renderer (``convert.InputBuffer``), so a
moved camera or a recoloured light replays the same graph. A new scene,
a resize, another light count or other settings change the key and
capture again.

The graph's outputs are overwritten by each replay, so every frame
returns copies of them, which stay valid however many frames follow.
The intermediates of the captured frame live in the graph's private
memory pool. ``utils/debug.check_outputs`` runs on the copies, outside
the graph.

``kernels/build.launch_counts`` counts what the host launches: the eager
frames' kernels, and under ``frame_graph`` one launch of the graph a
replayed frame. The kernel wrappers' calls while the graph records launch
nothing: they stay out of the counters and are kept, by counter, in
``recorded``; ``captures`` counts the captures. What a replay runs on the
card is read from a ``torch.profiler`` trace by kernel name
(``build.KERNEL_OF``).
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..utils.debug import check_outputs, validation


def frame_key(x):
    """A hashable key of a frame's inputs: tensors by (address, shape,
    strides, dtype, device), dicts, lists and tuples item by item, other
    values as they are."""
    if isinstance(x, torch.Tensor):
        return ("tensor", x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                x.device)
    if isinstance(x, dict):
        return ("dict", tuple((k, frame_key(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(frame_key(v) for v in x))
    return x


class FrameGraph:
    def __init__(self):
        self.key = None
        self.graph = None
        self.noise = None     # the (2, 64, 64) noise maps the graph reads
        self.out = None       # the graph's outputs, overwritten per replay
        self.recorded = None  # the kernel launches the graph holds
        self.captures = 0

    def frame(self, inputs, noise, body) -> dict:
        """body(noise)'s outputs: eager where frame_key(inputs) is new,
        else replayed (captured at the first such frame)."""
        key = frame_key(inputs)
        if key != self.key:
            self.release()
            self.key = key
            return body(noise)
        if self.graph is None:
            self._capture(noise, body)
        else:
            self.noise.copy_(noise)
        self.graph.replay()
        build.launch_counts["frame_graph"] += 1
        out = {k: v.clone() for k, v in self.out.items()}
        check_outputs(out)
        return out

    def _capture(self, noise, body):
        self.noise = noise.clone()
        before = dict(build.launch_counts)
        graph = torch.cuda.CUDAGraph()
        # a stream of its own (the default stream cannot be captured); no
        # torch.cuda.graph context, which synchronises, collects garbage
        # and empties the allocator's cache first. The NaN check reads
        # back to the host: it runs on each frame's copies instead.
        with validation(nan_checks=False), torch.cuda.stream(
                torch.cuda.Stream(noise.device)):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = body(self.noise)
            finally:
                graph.capture_end()
        self.recorded = {k: n - before[k]
                         for k, n in build.launch_counts.items()
                         if n != before[k]}
        build.launch_counts.update(before)
        self.captures += 1
        self.graph = graph

    def release(self):
        """Drop the graph and its memory, after its last replay has run."""
        if self.graph is not None:
            torch.cuda.current_stream(self.noise.device).synchronize()
        self.key = self.graph = self.noise = self.out = self.recorded = None
