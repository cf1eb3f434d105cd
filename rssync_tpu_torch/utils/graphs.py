"""CUDA graphs kept per device, and their capture: the IRLS Sync trip
(`core/sync.py::_TripGraph`) and the tracker block
(`frontend/tracking.py::_BlockGraph`).

An entry holds a graph's static buffers and its memory pool, so a
cache keeps the last few used a device (`GraphCache`) and lets one
caller at a time load, replay and copy out of an entry."""

from __future__ import annotations

import gc
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Iterator, Sequence

import torch

#: entries a cache keeps per device: the last ones used, one a key
GRAPHS_PER_DEVICE = 4


class GraphCache(dict):
    """device -> (lock held through a use of the device's entries,
    OrderedDict key -> entry, the last GRAPHS_PER_DEVICE used)."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    @contextmanager
    def use(self, dev: torch.device, key, make: Callable[[], object]) -> Iterator:
        """The entry of key on dev (`make()` where there is none), under
        the device's lock: an entry's static buffers serve one caller at
        a time (`parallel/mesh.py` runs a device from each of its
        threads)."""
        with self._lock:
            lock, entries = self.setdefault(dev, (threading.Lock(), OrderedDict()))
        with lock:
            entry = entries.pop(key, None) or make()
            entries[key] = entry
            while len(entries) > GRAPHS_PER_DEVICE:
                entries.popitem(last=False)
            yield entry


def capture(dev: torch.device, warmup: Callable[[], None],
            stages: Sequence[Callable[[], None]]) -> list[torch.cuda.CUDAGraph]:
    """One CUDA graph a stage, captured in order into one memory pool
    after `warmup()` has run eagerly on a side stream, as torch's
    make_graphed_callables warms up. Garbage is collected first, as
    `torch.cuda.graph` does: a graph held in a reference cycle and
    destroyed by a collection during a capture would end it. Only this
    thread's captures are guarded (`thread_local`)."""
    gc.collect()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    with torch.cuda.stream(side):
        warmup()
        for stage in stages:
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                stage()
            finally:
                graph.capture_end()
            graphs.append(graph)
    torch.cuda.current_stream(dev).wait_stream(side)
    return graphs
