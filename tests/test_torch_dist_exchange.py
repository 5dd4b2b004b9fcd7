"""The exchange of the port's distributed six-step on the CPU
(``ntt_tpu_torch/dist/sixstep.py``): the negacyclic product on a local
mesh of four shards at the 62-bit prime of the benchmark's four-card cell
against the benchmark's plain reference, the spans of a distributed call
(its root, the exchange's phases, the kernels) as a profiler records them,
``trace.EXCHANGED`` against a count by hand, and ``dist.graph.Graphed``
(the call itself on the CPU; on cards, replays of one capture against the
reference, skipped without a card).  Everything on the CPU runs at m <= 10
on the plain PyTorch path; no JAX."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nttbench.reference import rns_product
from ntt_tpu_torch import trace
from ntt_tpu_torch.dist import graph
from ntt_tpu_torch.dist import sixstep as dist
from ntt_tpu_torch.params import NttParams

Q62 = 0x3FFFFFFFFA000001  # the largest 62-bit prime with 2^25 | q - 1
ROOT = "ntt_tpu_torch.dist."
EXCHANGE = "ntt_tpu_torch.exchange."
KERNEL = "ntt_tpu_torch.kernel."
CPU = torch.device("cpu")


def operands(m, rows, seed, q=Q62):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 1 << 62, (rows, 1 << m), generator=gen) % q
                 for _ in range(2))


def local_mesh(shards):
    return dist.Mesh(("x",), (shards,), (CPU,) * shards)


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("m,rows,seed", [(8, 1, 1), (10, 1, 2), (10, 2, 3)])
def test_product_on_four_shards_equals_the_reference(m, rows, seed):
    a, b = operands(m, rows, seed)
    got = dist.dist_negacyclic_mul(a, b, NttParams.make(Q62, m), local_mesh(4))
    assert torch.equal(got, rns_product.negacyclic(a, b, Q62))


CALLS = {
    "fwd": lambda a, b, p, mesh: dist.dist_fwd_ntt(a, p, mesh),
    "inv": lambda a, b, p, mesh: dist.dist_inv_ntt(a, p, mesh),
    "negacyclic": lambda a, b, p, mesh: dist.dist_negacyclic_mul(a, b, p, mesh),
    "rec_fwd": lambda a, b, p, mesh: dist.dist_rec_fwd_ntt(a, p, mesh),
    "rec_inv": lambda a, b, p, mesh: dist.dist_rec_inv_ntt(a, p, mesh),
    "batch_fwd": lambda a, b, p, mesh: dist.batch_parallel_fwd(a, p, mesh),
}
# the exchange's phases in the order a call runs them
PHASES = {"fwd": ["scatter", "all_to_all", "gather"], "inv": ["scatter", "all_to_all", "gather"],
          "negacyclic": ["scatter", "all_to_all", "all_to_all", "all_to_all", "gather"],
          "rec_fwd": ["scatter", "all_to_all", "gather"],
          "rec_inv": ["scatter", "all_to_all", "gather"], "batch_fwd": ["scatter", "gather"]}


@pytest.mark.parametrize("entry", sorted(CALLS))
def test_spans_nest_under_the_root(entry):
    """One root a call; the exchange's spans and the kernels' spans are its
    children, side by side: no kernel runs inside an exchange span."""
    a, b = operands(8, 4, 5)
    with profile(activities=[ProfilerActivity.CPU]):
        CALLS[entry](a, b, NttParams.make(Q62, 8), local_mesh(4))
    spans = trace.spans()
    assert spans[0].name == ROOT + entry and spans[0].parent == -1
    assert all(s.parent == 0 and s.root == 0 for s in spans[1:])
    assert [s.name.removeprefix(EXCHANGE) for s in spans
            if s.name.startswith(EXCHANGE)] == PHASES[entry]
    kernels = [s for s in spans if s.name.startswith(KERNEL)]
    assert kernels and len(kernels) + len(PHASES[entry]) + 1 == len(spans)
    for s in spans[1:]:
        assert spans[0].start_ns <= s.start_ns <= s.end_ns <= spans[0].end_ns
    ex = [s for s in spans if s.name.startswith(EXCHANGE)]
    for k in kernels:
        assert not any(e.start_ns < k.start_ns < e.end_ns for e in ex)


def test_spans_are_off_without_a_profiler(monkeypatch):
    def no_annotation(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_annotation)
    a, b = operands(8, 1, 6)
    dist.dist_negacyclic_mul(a, b, NttParams.make(Q62, 8), local_mesh(2))
    assert trace.spans() == []


# operands each phase moves between shards: the home shard keeps its own
# slice of each, every other shard's crosses once
BY_HAND = {"fwd": (1, 1, 1), "inv": (1, 1, 1), "negacyclic": (2, 3, 1)}


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("entry", sorted(BY_HAND))
def test_exchanged_bytes_by_hand(entry, shards):
    rows, m = 3, 8
    a, b = operands(m, rows, 7)
    trace.EXCHANGED.clear()
    CALLS[entry](a, b, NttParams.make(Q62, m), local_mesh(shards))
    operand = rows * (1 << m) * 8  # bytes of one operand, word 64
    crossing = operand * (shards - 1) // shards
    assert dict(trace.EXCHANGED) == {
        phase: k * crossing for phase, k in zip(("scatter", "all_to_all", "gather"),
                                                BY_HAND[entry])}


def test_graphed_on_the_cpu_is_the_call():
    """Off the cards there is no graph: each call runs the product."""
    p, mesh = NttParams.make(Q62, 8), local_mesh(4)
    g = graph.Graphed(lambda x, y: dist.dist_negacyclic_mul(x, y, p, mesh), operands(8, 1, 8),
                      mesh)
    assert g.graph is None
    for seed in (9, 10):
        a, b = operands(8, 1, seed)
        assert torch.equal(g(a, b), rns_product.negacyclic(a, b, Q62))


def test_graphed_refuses_a_rank_of_the_ranks_form():
    mesh = dist.Mesh(("x",), (2,), (CPU,), rank=0)
    with pytest.raises(ValueError, match="local mesh"):
        graph.Graphed(lambda x: x, (torch.zeros(4),), mesh)


def test_graphed_replays_equal_the_reference_on_the_cards():
    """On cards: four shards round robin over the cards there are, one
    capture, two replays on other operands; the first replay's output is
    still its own after the second."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU form")
    cards = tuple(torch.device("cuda", i % torch.cuda.device_count()) for i in range(4))
    mesh, p = dist.Mesh(("x",), (4,), cards), NttParams.make(Q62, 16)
    g = graph.Graphed(lambda x, y: dist.dist_negacyclic_mul(x, y, p, mesh),
                      tuple(t.to(cards[0]) for t in operands(16, 1, 11)), mesh)
    assert g.graph is not None
    runs = []
    for seed in (12, 13):
        a, b = operands(16, 1, seed)
        runs.append((g(a.to(cards[0]), b.to(cards[0])), a, b))
    for got, a, b in runs:
        assert torch.equal(got.cpu(), rns_product.negacyclic(a, b, Q62))
