"""BENCHMARK.json against the rules its runs depend on: every name found
by a file of its own, every metric by a reader, the names and units in
their character sets."""

from __future__ import annotations

import json
import re

import pytest

from nttbench.tests.conftest import PKG, REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"] for w in BENCH["workloads"]}
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nttbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in E2E


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("nttbench/")
    data = json.loads((REPO / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert (PKG / "systems" / f"{data['system']}.py").is_file()
    assert (PKG / "reference" / f"{data['reference']}.py").is_file()
    assert len(data["moduli"]) == len(data["moduli_bits"])
    for q, bits in zip(data["moduli"], data["moduli_bits"]):
        assert int(q, 16).bit_length() == bits
        assert (int(q, 16) - 1) % (2 << data["log_n"]) == 0
    assert len(set(data["moduli"])) == len(data["moduli"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    traffic = json.loads((PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    assert "ops" not in traffic  # the entry's file states its work, once
    assert (PKG / "entries" / f"{traffic['entry']}.json").is_file()
    per_layer = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", CELLS)]
    assert per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (PKG / "metrics" / f"{metric['name']}.py").is_file()
    assert set(metric.get("workloads", CELLS)) <= CELLS
    if metric["name"] in E2E:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in E2E and "bound" not in metric
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_names_unique():
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
