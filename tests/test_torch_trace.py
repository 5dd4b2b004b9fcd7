"""The port's spans and its launch counter (``ntt_tpu_torch/trace.py``) on
the CPU: off without a profiler, the tower's tree of spans under one,
the same tree in the profiler's Chrome trace on the same clock, the
recorder's bound, and the count of launches in ``native.launch``."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ntt_tpu_torch import api, native, rns, trace
from ntt_tpu_torch.params import NttParams

TOWER = "ntt_tpu_torch.tower."
OP = "ntt_tpu_torch.op."
KERNEL = "ntt_tpu_torch.kernel."


@pytest.fixture(scope="module")
def tower():
    tw = rns.DeviceRnsTower(6, (20, 20, 20), device="cpu")
    rng = np.random.default_rng(21)
    ra, rb = (tw.from_host(tw.encode(rng.integers(0, 1 << 19, size=(2, tw.n), dtype=np.uint64)))
              for _ in range(2))
    return tw, ra, rb


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_spans_are_off_without_a_profiler(tower, monkeypatch):
    def no_annotation(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", no_annotation)
    tw, ra, rb = tower
    tw.negacyclic(ra, rb)
    tw.pointwise_rep(ra, rb)
    with trace.span("ntt_tpu_torch.tower.anything"):
        pass
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.span("a") is trace.span("b")  # the one shared no-op context


def test_tower_call_records_one_tree(tower, tmp_path):
    """1 root, 3 op spans (one a channel), 12 kernel spans (two forwards,
    the product and the inverse a channel); the exported Chrome trace
    holds the same spans as user_annotation events, nested the same way,
    on the same clock."""
    tw, ra, rb = tower
    out, prof = _profiled(lambda: tw.negacyclic(ra, rb))
    assert all(torch.equal(o, c.negacyclic(a, b)) for o, c, a, b in zip(out, tw.ctxs, ra, rb))
    got = trace.spans()
    assert [s.name for s in got] == [TOWER + "negacyclic"] + 3 * (
        [OP + "negacyclic"] + [KERNEL + k for k in ("fwd_fused", "fwd_fused", "mul_mod",
                                                   "inv_fused")])
    ops = [i for i, s in enumerate(got) if s.name.startswith(OP)]
    assert ops == [1, 6, 11]
    for i, s in enumerate(got):
        assert s.root == 0
        want_parent = -1 if i == 0 else 0 if i in ops else max(o for o in ops if o < i)
        assert s.parent == want_parent, (i, s)
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert trace.dropped() == 0

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = sorted((e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"
                     and e["name"].startswith("ntt_tpu_torch.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == [s.name for s in got]
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    for e, s in zip(events, got):  # the profiler's clock: within a few ms, not hours
        assert abs(s.start_ns / 1e3 - base_us - e["ts"]) < 5e3, (e, s)
    for i, e in enumerate(events):  # the innermost enclosing annotation is the parent
        enclosing = [j for j, f in enumerate(events[:i])
                     if f["ts"] <= e["ts"] and e["ts"] + e["dur"] <= f["ts"] + f["dur"]]
        assert (enclosing[-1] if enclosing else -1) == got[i].parent


def test_a_kernel_call_alone_is_its_own_root():
    p = NttParams.generate(20, 5)
    a = np.arange(2 * p.n, dtype=np.uint64).reshape(2, p.n) % np.uint64(p.q)
    _profiled(lambda: api.negacyclic_mul(a, a, p, device="cpu"))
    got = trace.spans()
    assert got and all(s.name.startswith(KERNEL) for s in got)
    assert [(s.parent, s.root) for s in got] == [(-1, i) for i in range(len(got))]


def test_each_thread_nests_its_own_spans():
    seen = []

    def other():
        with trace.span("ntt_tpu_torch.op.other"):
            seen.append(True)

    def run():
        with trace.span("ntt_tpu_torch.tower.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()

    _profiled(run)
    got = {s.name: s for s in trace.spans()}
    assert seen == [True]
    assert got["ntt_tpu_torch.op.other"].parent == -1
    assert got["ntt_tpu_torch.tower.main"].parent == -1


def test_recorder_drops_and_counts_beyond_its_bound(tower, monkeypatch):
    assert trace.CAPACITY >= 2002 * 46  # the longest traced window of a 46-span step
    monkeypatch.setattr(trace, "CAPACITY", 5)
    tw, ra, rb = tower
    _profiled(lambda: tw.negacyclic(ra, rb))
    got = trace.spans()
    assert len(got) == 5 and None not in got
    assert [s.name for s in got] == [TOWER + "negacyclic", OP + "negacyclic"] + [
        KERNEL + k for k in ("fwd_fused", "fwd_fused", "mul_mod")]
    assert trace.dropped() == 16 - 5
    trace.reset()
    assert trace.spans() == [] and trace.dropped() == 0


def test_reset_refuses_an_open_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("ntt_tpu_torch.tower.open"):
            with pytest.raises(RuntimeError, match="span open"):
                trace.reset()
    assert [s.name for s in trace.spans()] == ["ntt_tpu_torch.tower.open"]


class _FakeLibrary:
    """Launchers that return 0, but ``ntt_fwd_fused_u64``, which refuses."""

    def __getattr__(self, name):
        if name == "ntt_error_string":
            return lambda err: b"refused"
        return lambda *args: 7 if name == "ntt_fwd_fused_u64" else 0


def test_native_launch_counts_each_launch_by_its_launcher(monkeypatch):
    monkeypatch.setattr(native, "lib", _FakeLibrary)
    before = trace.LAUNCHES.copy()
    native.launch("mul_mod_u64", 1, 2, 3)
    native.launch("mul_mod_u64", 1, 2, 3)
    native.launch("r4_stage_solinas_u32")
    with pytest.raises(RuntimeError, match="fwd_fused_u64 failed to launch"):
        native.launch("fwd_fused_u64")
    assert trace.LAUNCHES - before == {"mul_mod_u64": 2, "r4_stage_solinas_u32": 1}
