"""A step of the port captured in one CUDA graph: the bookkeeping that the
serve engine's ``StepGraph`` and the trainer's ``TrainStepGraph`` share.

A replayed graph launches its kernels without their wrappers, so the
capture (which executes nothing) rolls back the launch counts it ticked
and keeps their delta, and each replay adds it (``kernels/counters.py``):
the counts stay launches executed.  A graph reads and writes by address,
so it holds what its caller hands it and every split workspace alive at
the capture (a later growth of one replaces it, which would free memory
the graph still writes).
"""
from __future__ import annotations

import time

import torch


class CapturedStep:
    """``fn()`` captured in one CUDA graph on ``stream``, its memory in
    ``pool``; the caller has run ``fn`` eagerly on ``stream`` first
    (kernels loaded, TMA maps encoded, split workspaces at their final
    size).  ``out`` is what the capture returned: static tensors that each
    :meth:`replay` rewrites.  ``held``: what the graph reads or writes by
    address, kept alive as long as the graph."""

    def __init__(self, fn, *, stream, pool, held=()):
        from repro_torch.kernels import counters
        from repro_torch.kernels.mpgemm import split_workspaces

        self.graph = torch.cuda.CUDAGraph()
        before = counters.launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = fn()
        self.capture_s = time.perf_counter() - t0
        self.launches = counters.count_delta(counters.launch_counts(),
                                             before)
        counters.add_launch_counts(self.launches, times=-1)
        self._held = (*held, split_workspaces())
        self.replays = 0

    def replay(self):
        """Run the captured step on the current stream; -> ``out``."""
        from repro_torch.kernels import counters

        self.graph.replay()
        counters.add_launch_counts(self.launches)
        self.replays += 1
        return self.out


def pool_bytes(pool) -> int:
    """Bytes of the card's memory a graph pool (``torch.cuda.
    graph_pool_handle()``) holds; 0 for no pool."""
    if pool is None:
        return 0
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pool)
