"""One call of the distributed six-step over a local mesh, captured once as
a CUDA graph that spans the mesh's cards, and replayed.

A local mesh's call issues every shard's kernel launches and copies from
one host thread.  At N = 2^24 on four H100s that is 52 launches and about
60 copies a product, whose issue outlasts the cards' work, so the host
paces the call and its speed sets the rate.  A replay issues the same
launches and copies as one graph launch, and the cards pace the call.

``Graphed(fn, inputs, mesh)`` makes the call ``fn(*inputs)`` twice
eagerly (the plan's tables, the kernel library, peer access between the
cards), then once under stream capture.  The capture begins on a stream
of the home card (the first input's device); a stream on each other card
of the mesh joins it through an event and is made that card's current
stream, so every launch and copy of the call, on any card, becomes a node
of one graph, and each joins the home stream again before the capture
ends.  What the call allocates on the home card goes to the graph's own
pool; on each other card, to a ``torch.cuda.MemPool`` kept with the
graph, so no later allocation takes memory that a replay writes.

Each call of the object copies its operands into the captured inputs,
replays the graph on the home card's current stream and returns a copy of
the captured output, which the next replay overwrites.  The operands have
the captured inputs' shapes, dtypes and device.  On the CPU there is no
graph: each call is ``fn`` itself.  Only the local form of a mesh is
captured; a rank of the ranks form issues NCCL collectives of its own.

The spans of ``trace.py`` belong to the eager call: a replay opens none.
"""

from __future__ import annotations

import contextlib

import torch

from ntt_tpu_torch.dist.sixstep import Mesh

WARMUP_CALLS = 2


class Graphed:
    """``fn(*inputs)`` over the local ``mesh``, replayed by each call."""

    def __init__(self, fn, inputs: tuple[torch.Tensor, ...], mesh: Mesh):
        if mesh.rank is not None:
            raise ValueError(f"a graph captures a local mesh, not {mesh}")
        self.fn, self.home = fn, inputs[0].device
        self.graph = None
        if self.home.type != "cuda":
            return
        cards = list(dict.fromkeys([self.home, *mesh.devices]))
        self.inputs = tuple(x.clone() for x in inputs)
        for _ in range(WARMUP_CALLS):
            fn(*self.inputs)
        for d in cards:
            torch.cuda.synchronize(d)
        streams = {d: torch.cuda.Stream(d) for d in cards}
        self.pools = {}
        for d in cards[1:]:
            with torch.cuda.device(d):
                self.pools[d] = torch.cuda.MemPool()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=streams[self.home]), \
                contextlib.ExitStack() as joined:
            fork = torch.cuda.Event()
            fork.record(streams[self.home])
            for d in cards[1:]:
                streams[d].wait_event(fork)
                joined.enter_context(torch.cuda.stream(streams[d]))
                joined.enter_context(torch.cuda.use_mem_pool(self.pools[d], d))
            self.output = fn(*self.inputs)
            for d in cards[1:]:
                streams[self.home].wait_event(streams[d].record_event())

    def __call__(self, *xs: torch.Tensor) -> torch.Tensor:
        if self.graph is None:
            return self.fn(*xs)
        for x, static in zip(xs, self.inputs, strict=True):
            if (x.shape, x.dtype, x.device) != (static.shape, static.dtype, static.device):
                raise ValueError(f"an operand of {tuple(x.shape)} {x.dtype} on {x.device}; "
                                 f"the graph was captured on {tuple(static.shape)} "
                                 f"{static.dtype} on {static.device}")
            static.copy_(x)
        self.graph.replay()
        return self.output.clone()
