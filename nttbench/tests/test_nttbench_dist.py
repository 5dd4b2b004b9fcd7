"""The four-card cell of the distributed six-step at a tiny size on the CPU:
a copy of ``n24.dist.d4`` at N = 2^10 on four CPU stand-ins for its cards
through ``harness.run`` (on the CPU the system calls the program at each
step, where the cards replay a graph of the call), the frozen count of the exchange
(``exchange_work``) by hand and against the program's ``trace.EXCHANGED``,
and ``exchange_roofline`` on a hand-made trace of two cards."""

from __future__ import annotations

import json

import pytest
import torch

from ntt_tpu_torch import trace
from ntt_tpu_torch.dist import sixstep as dist
from ntt_tpu_torch.params import NttParams
from nttbench import exchange_work, harness
from nttbench import trace as tr
from nttbench import work as wk
from nttbench.tests.conftest import PKG, REPO, make_root

CPU = torch.device("cpu")
SEED = 2**31 + 2424
CELL = "tiny.dist"
Q = int(json.loads((PKG / "configs" / "dist-n24-q62.json").read_text())["moduli"][0], 16)
EXCHANGE_METRICS = {"exchange_roofline"}


@pytest.fixture(scope="module")
def dist_root(tmp_path_factory):
    """A root with ``n24.dist.d4`` copied at log_n 10 as the cell tiny.dist
    (its traffic as it is: one row, both sets checked whole)."""
    root = make_root(tmp_path_factory.mktemp("nttbench_dist"), cells={})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = dict(next(w for w in bench["workloads"] if w["name"] == "n24.dist.d4"), name=CELL)
    cfg = json.loads((PKG / "configs" / "dist-n24-q62.json").read_text())
    cfg.update(name="tiny.dist.config", log_n=10)
    (root / "nttbench" / "configs" / "tiny.dist.config.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": cfg["name"], "source": "a test", "reduced": cfg["reduced"],
                             "file": "nttbench/configs/tiny.dist.config.json", "why": "a test"})
    bench["workloads"].append(dict(cell, config=cfg["name"]))
    for m in bench["per_layer"]:
        if m["name"] in EXCHANGE_METRICS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, trace_on):
    trace.reset()
    return harness.run(CELL, SEED, 0.2, trace_on, CPU, root=root, log=lambda s: None)


@pytest.fixture
def exchange_time_as_on_the_cards(monkeypatch):
    """The trace's exchange group as the cards' would read: the CPU runs no
    device operation, so the group would hold no time; give it 1 ms a step."""
    reduce = tr.reduce

    def with_exchange(events, groups, cards):
        out = reduce(events, groups, cards)
        out["group_s"]["exchange"] = 1e-3 * out["steps"]
        return out

    monkeypatch.setattr(tr, "reduce", with_exchange)


def test_tiny_cell_untraced(dist_root):
    res = _run(dist_root, False)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"products_per_s", "setup_s"}
    assert res["device"]["count"] == 4
    checks = res["checks"]
    assert checks["mismatched_coeffs"]["value"] == 0
    assert checks["compared_coeffs"]["value"] == checks["compared_coeffs"]["limit"] == 2 * 1024
    assert trace.spans() == []


def test_tiny_cell_traced_reads_exchange_roofline(dist_root, exchange_time_as_on_the_cards):
    res = _run(dist_root, True)
    assert res["correct"] is True
    assert EXCHANGE_METRICS <= set(res["metrics"])
    assert res["metrics"]["exchange_roofline"]["unit"] == "%"
    # 6 S (D - 1) / D a step at S = 1024 words of 8 bytes, D = 4, over 1 ms a step
    want = 100 * 6 * 8192 * 3 // 4 / exchange_work.NVLINK_BYTES_PER_S / 1e-3
    assert res["metrics"]["exchange_roofline"]["value"] == pytest.approx(want)
    spans = trace.spans()
    assert trace.dropped() == 0
    roots = [s for s in spans if s.parent < 0]
    assert roots and {s.name for s in roots} == {"ntt_tpu_torch.dist.negacyclic"}
    per_root = {}
    for s in spans:
        if s.name.startswith("ntt_tpu_torch.exchange."):
            per_root[s.root] = per_root.get(s.root, 0) + (s.end_ns - s.start_ns) / 1e6
    assert len(per_root) == len(roots) and min(per_root.values()) > 0


def test_exchange_roofline_absent_on_one_card(dist_root):
    trace.reset()
    rec = {"trace": {"group_s": {"exchange": 1.0}, "steps": 10}, "chips": 1,
           "work": {"pointwise": wk.Work(bytes=3 << 20)}}
    assert harness.load_module(REPO, "metrics", "exchange_roofline").read(rec) is None


def test_exchange_work_by_hand():
    s = 8 << 24  # one N = 2^24 operand of 8-byte words
    assert exchange_work.phase_bytes("negacyclic", s, 4) == {
        "scatter": 2 * s * 3 // 4, "all_to_all": 3 * s * 3 // 4, "gather": s * 3 // 4}
    assert sum(exchange_work.phase_bytes("negacyclic", s, 4).values()) == 4.5 * s
    assert exchange_work.phase_bytes("fwd", s, 2) == dict.fromkeys(
        ("scatter", "all_to_all", "gather"), s // 2)
    assert set(exchange_work.phase_bytes("inv", s, 1).values()) == {0}
    # 4.5 x 128 MiB at 450 GB/s: 1.342 ms of card-seconds a step
    assert exchange_work.bound_s(9 * s // 2) == pytest.approx(1.3421772e-3)


@pytest.mark.parametrize("cards", [2, 4])
@pytest.mark.parametrize("entry", ["fwd", "inv", "negacyclic"])
def test_exchange_work_equals_the_programs_count(entry, cards):
    """On one call of the program, what ``trace.EXCHANGED`` counts is the
    frozen count's, phase by phase."""
    p = NttParams.make(Q, 8)
    gen = torch.Generator().manual_seed(cards)
    a, b = (torch.randint(0, 1 << 62, (3, p.n), generator=gen) % Q for _ in range(2))
    mesh = dist.Mesh(("x",), (cards,), (CPU,) * cards)
    trace.EXCHANGED.clear()
    if entry == "negacyclic":
        dist.dist_negacyclic_mul(a, b, p, mesh)
    else:
        getattr(dist, f"dist_{entry}_ntt")(a, p, mesh)
    assert dict(trace.EXCHANGED) == exchange_work.phase_bytes(entry, a.numel() * 8, cards)


def _ev(cat, name, ts, dur, device=None, corr=None):
    args = {} if device is None else {"device": device}
    if corr is not None:
        args["correlation"] = corr
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": args}


def test_exchange_roofline_from_a_two_card_trace():
    """One step on two cards: a peer copy (on card 0), a layout copy and a
    memcpy on card 1, a K4 launch; the exchange group holds the three
    copies' 30 us, and K4 stays in ``transforms``."""
    copy = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
            "operator()() const::{lambda()#7}::operator()() const::{lambda(long)#1}>"
            "(at::TensorIteratorBase&, at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
            "::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::{lambda(long)#1}"
            " const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<>)")
    k4 = "void ntt::fwd_cols_kernel<unsigned long long, ntt::ShoupRed>(unsigned long long*)"
    peer = _ev("gpu_memcpy", "Memcpy PtoP (Device -> Device)", 110, 10)
    peer["args"] = {"fromDevice": 0, "inDevice": 0, "toDevice": 1}
    events = [_ev("user_annotation", tr.STEP, 100, 100),
              _ev("user_annotation", tr.PHASES[0], 100, 60),
              _ev("user_annotation", tr.PHASES[1], 160, 40),
              peer,
              _ev("kernel", copy, 125, 12, device=1),
              _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 140, 8, device=1),
              _ev("kernel", k4, 150, 20, device=1)]
    t = tr.reduce(events, tr.load_groups(PKG / "kernel_groups"), 2)
    assert t["group_s"]["exchange"] == pytest.approx(30e-6)
    assert t["group_s"]["transforms"] == pytest.approx(20e-6)
    assert t["unmatched_s"] == {}
    moduli, n = [Q], 1 << 12
    rec = {"trace": t, "chips": 2,
           "work": wk.step_work(moduli, n, 1, [{"op": "pointwise", "count": 1,
                                                "group": "pointwise"}])}
    moved = 6 * (8 * n) // 2  # 6 S (D - 1) / D
    got = harness.load_module(REPO, "metrics", "exchange_roofline").read(rec)
    assert got == pytest.approx(100 * moved / 450e9 / 30e-6)


def test_exchange_group_leaves_the_accepted_cells_kernels_alone():
    """The bfv14 cells' kernels (their traced runs' device operations) match
    no pattern of the exchange group."""
    exchange = tr.load_groups(PKG / "kernel_groups")["exchange"]
    for name in ("ntt::rounds_kernel<unsigned long long, 4, 512, 1, false, ntt::ShoupRed>",
                 "ntt::mul_mod_kernel<unsigned long long, ntt::MulModConsts64>"):
        assert not any(p.search(name) for p in exchange)
