"""One inference request captured in a CUDA graph and replayed.

The port's counterpart of running one compiled program: a request of the
kernel path is ~730 device operations, each launched from Python, and the
card idles most of a request while the host launches them. A CUDA graph
records the launches once and replays them with one call.

The capture holds because the kernel path reads nothing back to the host:
every kernel's launch configuration and scratch come from the shapes, so
one capture serves every request of those shapes. A capture that fails
raises; nothing falls back to eager launches.
"""

from __future__ import annotations

import torch


class GraphedRequest:
    """``fn(*inputs) -> tuple of tensors`` captured on static copies of
    ``example`` (CUDA tensors, whose shapes and dtypes every later call
    keeps).

    Construction calls ``fn`` once eagerly on a side stream (the warm-up:
    it builds the kernel library, fills the wrappers' caches, such as the
    cluster FPS's occupancy check, and warms the caching allocator), then
    once under capture. So ``fn``'s kernel wrappers count two launches of
    each kernel here, and none at a replay. A call copies its inputs into
    the static buffers, replays the graph, and clones the outputs out, so
    the next call cannot overwrite what a caller holds."""

    def __init__(self, fn, *example: torch.Tensor):
        self.inputs = tuple(x.clone() for x in example)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: a server thread that touches the card meanwhile
        # (outside this capture) does not invalidate it
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = tuple(fn(*self.inputs))

    def __call__(self, *inputs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        if len(inputs) != len(self.inputs):
            raise ValueError(f"the graph takes {len(self.inputs)} inputs, got {len(inputs)}")
        for buf, x in zip(self.inputs, inputs, strict=True):
            if x.shape != buf.shape or x.dtype != buf.dtype:
                raise ValueError(f"the graph was captured for {tuple(buf.shape)} {buf.dtype}, "
                                 f"got {tuple(x.shape)} {x.dtype}")
            buf.copy_(x)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)
