"""The trace's reduction on a hand-made trace of two steps."""

from __future__ import annotations

import pytest

from nttbench import trace as tr


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
