"""The two readers of the program's spans, ``launch_host_us`` and
``lead_in_us``, through ``harness.run`` on a tiny cell on the CPU: read
in a traced run, absent from an untraced one, and absent where the
program records no span (the control) or launches nothing (the CPU's
plain path, as it is)."""

from __future__ import annotations

import pytest
import torch

from ntt_tpu_torch import trace
from nttbench import control, harness
from nttbench import trace as tr
from nttbench.tests.conftest import TINY

CPU = torch.device("cpu")
SEED = 2**31 + 4242
SPAN_METRICS = {"launch_host_us", "lead_in_us"}


def _run(root, cell, trace_on, system=None):
    trace.reset()
    return harness.run(cell, SEED, 0.2, trace_on, CPU, root=root, system=system,
                       log=lambda s: None)


@pytest.fixture
def launches_as_on_the_card(monkeypatch):
    """The trace's launch count as the card's would read: there, each
    kernel-wrapper span is one launch; the CPU's plain path launches
    nothing, so the readers would find no launch to cost."""
    reduce = tr.reduce

    def with_launches(events, groups, cards):
        out = reduce(events, groups, cards)
        out["launches"] = sum(s.name.startswith("ntt_tpu_torch.kernel.")
                              for s in trace.spans()) / out["steps"]
        return out

    monkeypatch.setattr(tr, "reduce", with_launches)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_span_metrics_read_in_a_traced_run(tiny_root, cell, launches_as_on_the_card):
    res = _run(tiny_root, cell, True)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert SPAN_METRICS <= set(got)
    assert all(res["metrics"][k]["unit"] == "us" for k in SPAN_METRICS)
    spans = trace.spans()
    assert trace.dropped() == 0
    roots = [s for s in spans if s.parent < 0]
    assert roots and all(s.name.startswith("ntt_tpu_torch.tower.") for s in roots)
    kernel_us = [(s.end_ns - s.start_ns) / 1e3 for s in spans
                 if s.name.startswith("ntt_tpu_torch.kernel.")]
    assert min(kernel_us) <= got["launch_host_us"] <= max(kernel_us)
    # the lead-in holds its step's first kernel span whole, within its root
    assert min(kernel_us) <= got["lead_in_us"] <= max((s.end_ns - s.start_ns) / 1e3
                                                      for s in roots)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_span_metrics_absent_untraced(tiny_root, cell):
    res = _run(tiny_root, cell, False)
    assert res["correct"] is True
    assert not SPAN_METRICS & set(res["metrics"])
    assert trace.spans() == []  # no profiler, no span


def test_span_metrics_absent_without_spans(tiny_root, launches_as_on_the_card):
    """The control (the reference in the program's place) records none."""
    res = _run(tiny_root, "tiny.bfv.mul", True, system=control.control_system)
    assert res["correct"] is False
    assert not SPAN_METRICS & set(res["metrics"])


def test_span_metrics_absent_where_nothing_launched(tiny_root):
    """The CPU's plain path as it is: spans, but no kernel launch to cost."""
    res = _run(tiny_root, "tiny.bfv.mul", True)
    assert trace.spans()
    assert not SPAN_METRICS & set(res["metrics"])
