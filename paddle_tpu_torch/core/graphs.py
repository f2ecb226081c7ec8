"""Capture and replay of CUDA graphs: the one mechanism behind the
serving engine's programs (`inference/programs.py`) and `to_static`'s
compiled functions (`jit/api.py`).

A graph is captured on a side stream (`side_stream`, one per device) into
a memory pool its owner gives (every graph of one engine, or of one
`CompiledFunction`, shares one pool), after an optional dry run on the
same stream that creates what a capture may not (cuBLAS handles and
workspaces, kernel modules, lazy buffers). A replay runs on that stream,
which first waits for the caller's stream, and the caller's stream then
waits for it, so a replay is ordered with everything around it as an
eager call would be.

Launch counters (`ops._cuda_common`): the wrappers count in Python, so
they count at the dry run and at the capture and never at a replay. The
dry run and the capture leave the counters as they were (`launches_of`)
and each replay adds the launches the capture made (`count_launches`):
a replayed graph counts exactly what the same call made eagerly counts.
"""
from __future__ import annotations

import time

import torch

from ..ops._cuda_common import count_launches, launches_of

#: the side stream every graph on a device is captured and replayed on.
#: One per device, not one per owner: torch keeps a cuBLAS workspace (32
#: MiB on sm90) for each stream that runs a GEMM until the process ends,
#: so a stream per engine left 32 MiB behind every engine (`generate()`
#: builds one per call). Owners run their graphs one at a time, and each
#: replay waits for the caller's stream and it for the replay, so sharing
#: the stream orders nothing that was not ordered
_SIDE_STREAMS: dict = {}


def side_stream(device) -> torch.cuda.Stream:
    device = torch.device(device)
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class Captured:
    """A captured graph, its static output (whatever the body returned)
    and the kernel launches each replay stands for."""

    __slots__ = ("graph", "output", "launches", "capture_s", "stream")

    def __init__(self, graph, output, launches, capture_s, stream):
        self.graph = graph
        self.output = output
        self.launches = launches
        self.capture_s = capture_s
        self.stream = stream

    def replay(self, before=None) -> None:
        """One replay on the capture's stream (`before()` first runs
        there: the copies into the static inputs), ordered after the
        caller's work and before the caller's next; adds the capture's
        launches to the counters."""
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            if before is not None:
                before()
            self.graph.replay()
        caller.wait_stream(self.stream)
        count_launches(self.launches)


def capture(body, stream, pool, generators=(), dry_run=None) -> Captured:
    """Run `dry_run()` (when given) and capture `body()` into a CUDA
    graph, both on `stream`, the graph's memory from `pool`; each
    explicit generator in `generators` is registered with the graph, so
    that each replay advances it (torch registers the default CUDA
    generator itself). Raises what the dry run or the capture raised;
    the caller names the program."""
    t0 = time.perf_counter()
    caller = torch.cuda.current_stream(stream.device)
    stream.wait_stream(caller)
    holder = {}
    with torch.cuda.stream(stream):
        if dry_run is not None:
            launches_of(dry_run)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)

        def run():
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                holder["out"] = body()

        launches = launches_of(run)
    caller.wait_stream(stream)
    return Captured(graph, holder["out"], launches,
                    time.perf_counter() - t0, stream)
