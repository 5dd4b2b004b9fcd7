"""The trace's reduction on a hand-made trace of two steps, on one card
and with its device operations spread over several."""

from __future__ import annotations

import pytest

from nttbench import harness
from nttbench import trace as tr
from nttbench import work as wk
from nttbench.tests.conftest import REPO


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


ROUNDS = "void ntt::rounds_kernel<unsigned long long, 4>(unsigned long long const*)"
MUL = "void ntt::mul_mod_kernel<unsigned long long>(long long)"
EVENTS = [
    # the profiler's warm-up step, before the window
    _ev("user_annotation", tr.WARMUP, 0, 90),
    _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
    _ev("kernel", ROUNDS, 10, 50, corr=1),
    # step 1: 100-200 us, issue 100-130, sync 130-200
    _ev("user_annotation", tr.STEP, 100, 100),
    _ev("user_annotation", tr.PHASES[0], 100, 30),
    _ev("cpu_op", "aten::empty_like", 102, 6),
    _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=2),
    _ev("cuda_runtime", "cudaLaunchKernel", 120, 4, corr=3),
    _ev("user_annotation", tr.PHASES[1], 130, 70),
    _ev("cuda_runtime", "cudaDeviceSynchronize", 131, 68),
    _ev("kernel", ROUNDS, 112, 40, corr=2),
    _ev("kernel", MUL, 150, 30, corr=3),
    # step 2: 210-300 us; its first kernel reads as starting before the step
    # (the device's clock offset from the host's); one kernel in no group
    _ev("user_annotation", tr.STEP, 210, 90),
    _ev("user_annotation", tr.PHASES[0], 210, 20),
    _ev("cuda_runtime", "cudaLaunchKernel", 212, 3, corr=4),
    _ev("cuda_runtime", "cudaLaunchKernel", 218, 3, corr=5),
    _ev("user_annotation", tr.PHASES[1], 230, 70),
    _ev("kernel", "void other_kernel(int)", 205, 40, corr=4),
    _ev("kernel", MUL, 260, 20, corr=5),
    _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 285, 5),
    _ev("cpu_op", "aten::ones", 220, 5, tid=2),  # another thread: not the steps'
]
GROUPS = {"transforms": [tr.re.compile(r"(^|::)rounds_kernel\b")],
          "pointwise": [tr.re.compile(r"(^|::)mul_mod_kernel\b")]}


def test_reduce_hand_made_trace():
    r = tr.reduce(EVENTS, GROUPS)
    assert r["steps"] == 2
    assert r["window_s"] == pytest.approx(200e-6)
    # busy: 112-180 (68), 205-245 (40), 260-280 (20), 285-290 (5)
    assert r["busy_s"] == pytest.approx(133e-6)
    assert r["group_s"]["transforms"] == pytest.approx(40e-6)  # the warm-up's is outside
    assert r["group_s"]["pointwise"] == pytest.approx(50e-6)
    assert r["unmatched_s"] == {"other_kernel": pytest.approx(40e-6),
                                "Memcpy DtoD (Device -> Device)": pytest.approx(5e-6)}
    assert r["launches"] == 2 and r["launches_range"] == [2, 2]
    gaps = dict(r["idle_gaps"])
    # 100-112 issue (midpoint in aten::empty_like); 180-205 cut at 200 into
    # sync (in cudaDeviceSynchronize) and between the steps; 245-260,
    # 280-285 and 290-300 in step 2's sync
    assert gaps == {"issue: aten::empty_like": pytest.approx(12e-6),
                    "sync: cudaDeviceSynchronize": pytest.approx(20e-6),
                    "between steps": pytest.approx(5e-6),
                    "sync": pytest.approx(30e-6)}
    assert r["device_ops"][:2] == [["ntt::mul_mod_kernel<unsigned long long>", pytest.approx(50e-6)],
                                   ["ntt::rounds_kernel<unsigned long long, 4>", pytest.approx(40e-6)]]


def test_kernel_name():
    assert tr.kernel_name("void ntt::f<int, (bool)1>(int*, float)") == "ntt::f<int, (bool)1>"
    assert tr.kernel_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD (Device -> Device)"


def test_no_steps_raises():
    with pytest.raises(ValueError):
        tr.reduce([_ev("kernel", "k", 0, 1)], GROUPS)


def test_a_kernel_in_two_groups_raises():
    """A new group file can never take device time from an old group."""
    groups = dict(GROUPS, k1=[tr.re.compile(r"rounds_kernel")])
    with pytest.raises(ValueError, match="more than one group"):
        tr.reduce(EVENTS, groups)


def _on_cards(events, cards):
    """``events`` with the device operations that start at a time in
    ``cards`` ({ts: card}) moved to that card: a kernel's ``device``, a
    copy's ``inDevice``, as the profiler names a copy between two cards."""
    out = []
    for e in events:
        if e["cat"] in tr.DEVICE_CATS and e["ts"] in cards:
            key = "inDevice" if e["cat"] == "gpu_memcpy" else "device"
            e = dict(e, args={**e.get("args", {}), key: cards[e["ts"]]})
        out.append(e)
    return out


# step 1's pointwise kernel (150-180) and step 2's copy (285-290) on card 1
TWO_CARDS = _on_cards(EVENTS, {150: 1, 285: 1})


def test_reduce_on_two_cards():
    r = tr.reduce(TWO_CARDS, GROUPS, 2)
    # card 0: 112-152, 205-245, 260-280; card 1: 150-180, 285-290
    assert r["busy_by_card_s"] == [pytest.approx(100e-6), pytest.approx(35e-6)]
    assert r["busy_s"] == pytest.approx(67.5e-6)
    # card 0's gaps are the one-card trace's, less 152-180 of step 1's sync;
    # card 1's: 100-130 issue (its midpoint at the end of a launch call),
    # 130-150 and 180-200 sync, 200-210 between the steps, 210-230 issue,
    # 230-285 and 290-300 sync; the sum of both over the two cards
    gaps = dict(r["idle_gaps"])
    assert gaps == {"issue: aten::empty_like": pytest.approx(12e-6 / 2),
                    "sync: cudaDeviceSynchronize": pytest.approx((48e-6 + 40e-6) / 2),
                    "between steps": pytest.approx((5e-6 + 10e-6) / 2),
                    "sync": pytest.approx((35e-6 + 65e-6) / 2),
                    "issue: cudaLaunchKernel": pytest.approx(50e-6 / 2)}
    assert sum(gaps.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    # device seconds and launches are summed over the cards, as on one card
    one = tr.reduce(EVENTS, GROUPS)
    for key in ("steps", "window_s", "group_s", "unmatched_s", "launches", "launches_range",
                "device_ops"):
        assert r[key] == one[key]


def test_a_card_with_no_operation_reads_idle():
    r = tr.reduce(TWO_CARDS, GROUPS, 4)
    assert r["busy_by_card_s"] == [pytest.approx(100e-6), pytest.approx(35e-6), 0.0, 0.0]
    assert r["busy_s"] == pytest.approx(135e-6 / 4)
    # each idle card's gaps are the whole window, cut at the phases
    idle_card = {"issue: cudaLaunchKernel": 50e-6, "sync: cudaDeviceSynchronize": 70e-6,
                 "between steps": 10e-6, "sync": 70e-6}
    two = dict(tr.reduce(TWO_CARDS, GROUPS, 2)["idle_gaps"])
    gaps = dict(r["idle_gaps"])
    assert gaps == {k: pytest.approx((2 * two.get(k, 0.0) + 2 * idle_card.get(k, 0.0)) / 4)
                    for k in set(two) | set(idle_card)}
    assert sum(gaps.values()) == pytest.approx(r["window_s"] - r["busy_s"])


def test_an_operation_outside_the_cells_cards_raises():
    with pytest.raises(ValueError, match="outside the cell's 1 card"):
        tr.reduce(TWO_CARDS, GROUPS)


def test_step_roofline_over_card_seconds():
    """The same traced work on four cards has four times the card-seconds."""
    step_roofline = harness.load_module(REPO, "metrics", "step_roofline")
    trace = tr.reduce(TWO_CARDS, GROUPS, 4)
    work = {"transforms": wk.transform(1 << 14, 8, 64), "pointwise": wk.pointwise(1 << 14, 8, 64)}
    one, four = (step_roofline.read({"trace": trace, "work": work, "chips": chips})
                 for chips in (1, 4))
    assert four == pytest.approx(one / 4)
    assert one == pytest.approx(wk.roofline_pct(
        (work["transforms"] + work["pointwise"]) * 2, 200e-6))
