"""The benchmark's work counts against hand counts, and the roofline
arithmetic."""

from __future__ import annotations

import json

import pytest

from nttbench import work
from nttbench.tests.conftest import PKG


@pytest.mark.parametrize("word, size, mul", [(32, 4, 3), (64, 8, 10)])
def test_forward_inverse_pointwise_by_hand(word, size, mul):
    # N = 8, 2 rows: 8 words a row, 3 stages of 4 butterflies
    fwd = work.transform(8, 2, word)
    assert fwd.bytes == 2 * 2 * 8 * size + 2 * 8 * size  # rows in and out, 8 roots + 8 constants
    assert fwd.muls == 2 * 12 * mul
    inv = work.transform(8, 2, word, inverse=True)
    assert inv.bytes == fwd.bytes
    assert inv.muls == 2 * (12 + 4) * mul  # N^-1 folded into the last stage: N/2 more
    pw = work.pointwise(8, 2, word)
    assert pw.bytes == 3 * 2 * 8 * size
    assert pw.muls == 2 * 8 * mul


def test_word_rule():
    assert work.word((1 << 30) - 35) == 32
    assert work.word(0xfffffffd8001) == 64


def test_step_work_sums_channels_and_ops():
    ops = json.loads((PKG / "entries" / "negacyclic.json").read_text())["ops"]
    qs = [0xfffffffd8001, 0x1fffffff68001]
    got = work.step_work(qs, 1 << 14, 1024, ops)
    t = work.transform(1 << 14, 1024, 64)
    i = work.transform(1 << 14, 1024, 64, inverse=True)
    assert got["transforms"] == (t * 2 + i) * 2
    assert got["pointwise"] == work.pointwise(1 << 14, 1024, 64) * 2


def _launch_butterflies(n_log: int, split: list[int]) -> int:
    """Butterflies that passes of `split` stages each do on one polynomial."""
    assert sum(split) == n_log
    return sum((1 << n_log) // 2 * stages for stages in split)


@pytest.mark.parametrize("split", [[14], [7, 7], [6, 8], [4, 4, 4, 2]])
def test_splitting_into_launches_keeps_the_bound(split):
    """One fused launch or passes of any split do the same butterflies,
    and the bound is the operation's, so it reads the same."""
    n_log = 14
    assert _launch_butterflies(n_log, split) == (1 << n_log) // 2 * n_log
    one = work.transform(1 << n_log, 1024, 64)
    assert one.muls == 1024 * _launch_butterflies(n_log, split) * 10
    assert work.bound_s(one) == work.bound_s(work.transform(1 << n_log, 1024, 64))


def test_bound_and_roofline():
    # m14, 1024 rows, word 64: the forward moves 268.7 MB, 80.2 us at 3.35 TB/s
    fwd = work.transform(1 << 14, 1024, 64)
    assert work.bound_s(fwd) == pytest.approx(fwd.bytes / 3.35e12)
    assert work.bound_s(fwd) == pytest.approx(80.2e-6, rel=1e-3)
    assert work.roofline_pct(fwd, 2 * work.bound_s(fwd)) == pytest.approx(50.0)
    heavy = work.Work(bytes=0, muls=67e12 / 4)
    assert work.bound_s(heavy) == pytest.approx(1.0)


@pytest.mark.parametrize("path", sorted(PKG.joinpath("entries").glob("*.json")),
                         ids=lambda p: p.stem)
def test_entries_name_known_ops_and_groups(path):
    groups = {p.stem for p in PKG.joinpath("kernel_groups").glob("*.json")}
    ops = json.loads(path.read_text())["ops"]
    assert ops and all(o["op"] in work.OPS and o["group"] in groups and o["count"] >= 1
                       for o in ops)
