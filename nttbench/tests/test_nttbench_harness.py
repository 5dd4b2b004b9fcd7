"""The harness end to end at a tiny size on the CPU, through the port's
plain PyTorch path: the result line, the traced run, the faults that the
check must catch, the control, and the command's refusals."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from nttbench import control, harness
from nttbench.tests.conftest import REPO, TINY, make_root

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # larger than 32 signed bits hold, as a run's seed may be


def _run(root, cell, system=None, trace=False, seed=SEED):
    return harness.run(cell, seed, 0.2, trace, CPU, root=root, system=system,
                       log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_run_is_correct_and_well_formed(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"products_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"
    assert res["checks"]["mismatched_coeffs"]["value"] == 0
    assert res["checks"]["compared_coeffs"]["value"] == res["checks"]["compared_coeffs"]["limit"]


def test_same_seed_same_inputs(tiny_root):
    cell = harness.Cell.load("tiny.bfv.mul", tiny_root)
    a = harness.make_inputs(cell, SEED, CPU)
    b = harness.make_inputs(cell, SEED, CPU)
    c = harness.make_inputs(cell, SEED + 1, CPU)
    assert all(torch.equal(x, y) for s, t in zip(a, b) for u, v in zip(s, t) for x, y in zip(u, v))
    assert not torch.equal(a[0][0][0], c[0][0][0])
    for s in a:
        for operand in s:
            for x, q in zip(operand, cell.moduli):
                assert int(x.min()) >= 0 and int(x.max()) < q


def test_traced_run_reports_per_layer_metrics(tiny_root):
    res = _run(tiny_root, "tiny.bfv.mul", trace=True)
    assert res["correct"] is True
    # no device operation runs on the CPU: the trace's readers find nothing
    # to read and leave their metrics out; the host's and the tables' remain
    assert set(res["metrics"]) == {"host_ms_per_step", "tables_s"}
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


class _Fault:
    """The port's tower with its timed path broken underneath."""

    def __init__(self, kind):
        self.kind = kind

    def __call__(self, config, device):
        sut, times = harness.load_module(REPO, "systems", config["system"]).build(config, device)
        self.sut, self.moduli = sut, [int(q, 16) for q in config["moduli"]]
        return self, times

    def _broken(self, outs, ra):
        if self.kind == "unchanged":  # a step that returns its state unchanged
            return [a.clone() for a in ra]
        if self.kind == "half_batch":  # half of the batch left out
            outs = [o.clone() for o in outs]
            for o in outs:
                o[o.shape[0] // 2:] = 0
            return outs
        if self.kind == "altered":  # one answer altered where it is produced
            outs = [o.clone() for o in outs]
            outs[-1][-1, 3] = (outs[-1][-1, 3] + 1) % self.moduli[-1]
            return outs
        raise ValueError(self.kind)

    def negacyclic(self, ra, rb):
        return self._broken(self.sut.negacyclic(ra, rb), ra)

    def pointwise_rep(self, ra, rb):
        return self._broken(self.sut.pointwise_rep(ra, rb), ra)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["tiny.bfv.mul", "tiny.bfv.pointwise"])
def test_faults_read_not_correct(tiny_root, cell, kind):
    res = _run(tiny_root, cell, system=_Fault(kind))
    assert res["correct"] is False
    assert res["failed"] > 0
    assert res["checks"]["mismatched_coeffs"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_reads_not_correct(tiny_root, cell):
    """The reference in the program's place, in float64 products."""
    res = _run(tiny_root, cell, system=control.control_system)
    assert res["correct"] is False
    checks = res["checks"]
    assert checks["mismatched_coeffs"]["value"] > checks["compared_coeffs"]["value"] // 2


def test_control_module_builds_the_reference_tower():
    cfg = json.loads((REPO / "nttbench/configs/seal-bfv-n16384.json").read_text())
    tower, times = control.control_system(cfg, CPU)
    assert tower.moduli == [int(q, 16) for q in cfg["moduli"]]
    assert times == {"library_s": 0.0, "tables_s": 0.0}


def _command(cwd, *args, env=None):
    return subprocess.run([sys.executable, "-m", "nttbench", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_command_without_a_card_exits_without_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = _command(REPO, "--workload", "bfv14.mul.b1024", "--seed", str(SEED), "--seconds", "1",
                 "--trace", "0")
    assert p.returncode == 2
    assert p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_command_alone_exits_without_result(tmp_path):
    """In a directory with only BENCHMARK.json and nttbench/, the program
    is missing: non-zero exit, no result."""
    shutil.copytree(REPO / "nttbench", tmp_path / "nttbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _command(tmp_path, "--workload", "bfv14.mul.b1024", "--seed", "1", "--seconds", "1",
                 "--trace", "0", env=env)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("chips", [1, 4])
def test_each_card_of_a_cell_is_handed_synchronised_and_counted(tmp_path, monkeypatch, chips):
    """A cell of ``chips`` cards: the system gets every card, home first;
    each synchronise (after the warm-up, each measured step, each traced
    step) waits for each card in turn; the line counts the cards."""
    root = make_root(tmp_path, cells={"tiny.cards": TINY["tiny.bfv.mul"]})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    next(w for w in bench["workloads"] if w["name"] == "tiny.cards")["chips"] = chips
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    synced, handed = [], []
    sync = harness._sync
    monkeypatch.setattr(harness, "_sync", lambda d: (synced.append(d), sync(d)))

    def system(config, devices):
        handed.append(list(devices))
        return harness.load_module(REPO, "systems", config["system"]).build(config, devices)

    res = _run(root, "tiny.cards", system=system, trace=True)
    cards = [CPU] + [torch.device("cpu", i) for i in range(1, chips)]
    assert handed == [cards]
    assert res["correct"] is True
    assert res["device"]["count"] == chips
    _, _, channels, _, rows = TINY["tiny.bfv.mul"]
    assert synced == cards * (1 + res["attempted"] // (channels * rows))


def test_memory_peak_is_the_fullest_cards(monkeypatch):
    peaks = {0: 5 << 30, 1: 9 << 30, 2: 7 << 30, 3: 1 << 30}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: peaks[d.index])
    cards = harness.cell_devices(torch.device("cuda", 0), 4)
    assert cards == [torch.device("cuda", i) for i in range(4)]
    assert harness.memory_peak_bytes(cards) == 9 << 30
    assert harness.memory_peak_bytes(cards[:1]) == 5 << 30
    assert harness.memory_peak_bytes([CPU]) == 0
