"""Tiny cells for the benchmark's CPU tests: a copy of ``nttbench/`` and
``BENCHMARK.json`` in a temporary root, with configurations cut to a few
channels at small N and traffic cut to a few rows, run through the
port's plain PyTorch path."""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
PKG = REPO / "nttbench"

TINY = {
    # cell: (configuration copied, log_n, channels, traffic copied, rows)
    "tiny.bfv.mul": ("seal-bfv-n16384", 6, 3, "mul.b1024", 4),
    "tiny.bfv.pointwise": ("seal-bfv-n16384", 6, 3, "pointwise.b2048", 4),
}


def make_root(tmp: pathlib.Path, cells: dict = TINY) -> pathlib.Path:
    """A checkout-like root: BENCHMARK.json and nttbench/, with the tiny
    cells added as new files and entries."""
    root = tmp / "root"
    shutil.copytree(PKG, root / "nttbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (config, log_n, channels, traffic, rows) in cells.items():
        cfg = json.loads((PKG / "configs" / f"{config}.json").read_text())
        name = f"{cell}.config"
        cfg.update(name=name, log_n=log_n, moduli=cfg["moduli"][:channels],
                   moduli_bits=cfg["moduli_bits"][:channels])
        (root / "nttbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        tr = json.loads((PKG / "traffic" / f"{traffic}.json").read_text())
        tr.update(rows_per_channel=rows, sample_rows_per_channel=rows)
        (root / "nttbench" / "traffic" / f"{cell}.traffic.json").write_text(json.dumps(tr))
        bench["configs"].append({"name": name, "source": "a test", "reduced": [],
                                 "file": f"nttbench/configs/{name}.json", "why": "a test"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": f"{cell}.traffic",
                                   "chips": 1, "why": "a test"})
        for m in bench["per_layer"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return make_root(tmp_path_factory.mktemp("nttbench"))
