"""The port's distributed six-step, ``ntt_tpu_torch.dist.sixstep``, built
for a configuration: a local ``Mesh`` of one shard a card over the cell's
devices, driven from this process, and one plan a listed prime with its
tables on every card.  The traffic's ``entry`` names the method a step
calls; ``negacyclic`` runs ``dist_negacyclic_mul`` on each channel at its
defaults (the API's split, one chunk), the operands and the product whole
on the home card.  On cards the call is captured once, at a channel's
first step (inside the set-up's warm-up), as one CUDA graph across the
cards (``ntt_tpu_torch.dist.graph``), and each step replays it; on the
CPU each step is the call itself."""

from __future__ import annotations

import time

import torch


class DistSixstep:
    """The entries a step calls, over lists of one (rows, N) tensor a channel."""

    def __init__(self, plans: list, mesh, graphed, mul):
        self._graphed, self._mul = graphed, mul
        self.plans, self.mesh = plans, mesh
        self.graphs: list = [None] * len(plans)

    def negacyclic(self, ra: list, rb: list) -> list:
        for c, (a, b, plan) in enumerate(zip(ra, rb, self.plans)):
            if self.graphs[c] is None:
                self.graphs[c] = self._graphed(
                    lambda x, y, plan=plan: self._mul(x, y, plan, self.mesh), (a, b), self.mesh)
        return [g(a, b) for g, a, b in zip(self.graphs, ra, rb)]


def build(config: dict, devices: list[torch.device]) -> tuple[DistSixstep, dict[str, float]]:
    """(the system, {"library_s", "tables_s"}): the seconds to build or load
    the kernel library from its cache in the checkout, and to make the
    plans and put the tables that K4-K7 read on every card."""
    from ntt_tpu_torch.dist import graph, sixstep  # first: a program without graph stops here
    from ntt_tpu_torch import native
    from ntt_tpu_torch.params import NttParams
    from ntt_tpu_torch.plan import get_plan

    t0 = time.perf_counter()
    if devices[0].type == "cuda":
        native.lib()
    t1 = time.perf_counter()
    plans = [get_plan(NttParams.make(int(q, 16), config["log_n"])) for q in config["moduli"]]
    for plan in plans:
        for device in devices:
            tabs = plan.device_tables(device)
            tabs.w, tabs.w_con, tabs.w_inv, tabs.w_inv_con  # noqa: B018 (built at first use)
    mesh = sixstep.Mesh(("x",), (len(devices),), tuple(devices))
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    system = DistSixstep(plans, mesh, graph.Graphed, sixstep.dist_negacyclic_mul)
    return system, {"library_s": t1 - t0, "tables_s": t2 - t1}
