"""The serving engine's programs: one per key, captured once as a CUDA
graph on a card and replayed for every call.

Port of the program cache of paddle_tpu/inference/engine.py
(`ServingEngine._program`), which compiles one XLA executable per key and
runs it for every call. Here a `Program` holds

  * static input buffers, one per host value of the call (token ids,
    positions, block tables, scalars, sampling parameters), made from the
    first call's arrays: a key fixes every shape;
  * the body, a function of those buffers that runs the whole step (embed,
    every layer, the KV appends, logits and the token pick) and returns
    the token tensor, or None for a chunk that emits no token;
  * on a card, the `torch.cuda.CUDAGraph` of the body, its static output,
    and the kernel launches the graph holds.

Every call copies its host values into the static buffers (on a card
through pinned staging buffers, `non_blocking`) and then replays the
graph, or, on the CPU and on an engine that a check runs eagerly, calls
the body on the buffers. The first call of a key on a card first runs the
body once on the engine's side stream with trash inputs (`DRY_VALUES`:
block tables at TRASH_BLOCK, positions 0, the copy-on-write trash onto
trash, so only the trash block is written), which builds the kernels,
loads their modules, creates the cuBLAS handles and allocates the lazy
buffers, then captures the body on that stream and replays the graph for
the real call. That dry run (or, for a program run eagerly, its first
call) is the one the cost ledger counts (`cost`, obs/costs.py). The
capture and replay are `core.graphs`'s, which
`to_static` shares (launch counting under replay is described there).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import graphs
from ..obs.costs import extract_cost
from ..text.paged_cache import TRASH_BLOCK

#: the dry run's value of each input it does not fill with TRASH_BLOCK
#: (0, which is also position 0, token 0 and a greedy row): a prefill
#: reads its last position at true_len - 1, which must exist, and the
#: sampling rows get a neutral filter
DRY_VALUES = {"true_len": 1, "temperature": 1.0, "top_p": 1.0}


class Program:
    """One serving program: static inputs, the body over them and, once
    `capture` ran, the graph with its static output."""

    __slots__ = ("key", "inputs", "_host", "_staged", "_body", "_graph",
                 "cost", "entry")

    def __init__(self, key, values: dict, body, device):
        self.key = key
        self.inputs = {name: torch.empty(np.shape(v), device=device,
                                         dtype=torch.from_numpy(
                                             np.asarray(v)).dtype)
                       for name, v in values.items()}
        cuda = torch.device(device).type == "cuda"
        # host side of each input: a pinned staging tensor on a card (its
        # copy is asynchronous), the input itself on the CPU
        host = {n: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for n, t in self.inputs.items()} if cuda else self.inputs
        self._host = {n: t.numpy() for n, t in host.items()}
        self._staged = ([(host[n], t) for n, t in self.inputs.items()],
                        torch.cuda.Event()) if cuda else None
        self._body = body
        self._graph = None      # the graphs.Captured, once captured
        # the cost counted at the body's one eager run (obs.costs
        # extract_cost: the dry run before the capture, or the first call
        # of a program run eagerly), and its cost-ledger row
        self.cost = None
        self.entry = None

    @property
    def graph(self):
        return None if self._graph is None else self._graph.graph

    @property
    def capture_s(self) -> float:
        return 0.0 if self._graph is None else self._graph.capture_s

    def _load(self, values):
        """Copy the call's host values into the static inputs. On a card
        the copies are enqueued on the current stream from pinned
        buffers; the staging buffers are rewritten only once the previous
        call's copies have run."""
        if self._staged is not None:
            self._staged[1].synchronize()
        for name, v in values.items():
            self._host[name][...] = v
        if self._staged is not None:
            pairs, copied = self._staged
            for src, dst in pairs:
                dst.copy_(src, non_blocking=True)
            copied.record()

    def run(self, values, count=False):
        """One call: the host values into the static inputs, then the
        graph replayed on the engine's stream (which waits for the
        caller's stream, and the caller's for it), or the body called —
        with `count`, under the cost counter (`cost`). Returns the token
        tensor (None for a chunk that emits none)."""
        if self._graph is None:
            self._load(values)
            if count:
                self.cost, out = extract_cost(
                    lambda: self._body(self.inputs),
                    next(iter(self.inputs.values())).device,
                    args=self.inputs)
                return out
            return self._body(self.inputs)
        self._graph.replay(lambda: self._load(values))
        return self._graph.output

    def capture(self, stream, pool, generator=None, count=False) -> float:
        """The dry run (with `count`, under the cost counter: `cost`),
        then the capture of the body into a CUDA graph, both on `stream`,
        its memory from `pool` (every graph of one engine shares it).
        `generator` is the sampling generator a sampling key draws from:
        the graph registers it, so that each replay advances it. Returns
        the wall seconds of dry run, capture and instantiation. Raises,
        naming the key, when either fails."""

        def dry_run():
            for name, buf in self.inputs.items():
                buf.fill_(DRY_VALUES.get(name, TRASH_BLOCK))
            if count:
                self.cost, _ = extract_cost(
                    lambda: self._body(self.inputs), stream.device,
                    args=self.inputs)
            else:
                self._body(self.inputs)

        try:
            self._graph = graphs.capture(
                lambda: self._body(self.inputs), stream, pool,
                () if generator is None else (generator,), dry_run)
        except Exception as e:
            raise RuntimeError(f"capturing the serving program {self.key} "
                               f"failed: {e}") from e
        return self._graph.capture_s
