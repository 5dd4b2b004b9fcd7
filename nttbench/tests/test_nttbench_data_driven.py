"""A configuration, a traffic mix and a per-layer metric added as new
files, in a copy of nttbench/, are found by name and run at a tiny size on
the CPU, with no edit to any file that was there."""

from __future__ import annotations

import filecmp
import json
import os
import subprocess
import sys
import textwrap

from nttbench.tests.conftest import PKG, REPO, make_root

METRIC = '''
"""throwaway_traced_steps: the steps of the traced window."""


def read(rec):
    t = rec.get("trace")
    return None if not t else t["steps"]
'''


def test_new_files_alone_add_a_cell(tmp_path):
    root = make_root(tmp_path, cells={})
    nb = root / "nttbench"
    before = {p.relative_to(root): p.read_bytes() for p in nb.rglob("*") if p.is_file()}

    cfg = json.loads((PKG / "configs" / "seal-bfv-n16384.json").read_text())
    cfg.update(name="throwaway-config", log_n=5, moduli=cfg["moduli"][3:5],
               moduli_bits=cfg["moduli_bits"][3:5])
    (nb / "configs" / "throwaway-config.json").write_text(json.dumps(cfg))
    (nb / "traffic" / "throwaway.mix.json").write_text(json.dumps({
        "entry": "negacyclic", "rows_per_channel": 3, "loop": "closed", "in_flight": 1,
        "input_sets": 3, "sample_rows_per_channel": 3}))
    (nb / "metrics" / "throwaway_traced_steps.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway-config", "source": "a test", "reduced": [],
                             "file": "nttbench/configs/throwaway-config.json", "why": "a test"})
    bench["workloads"].append({"name": "throwaway.cell", "config": "throwaway-config",
                               "traffic": "throwaway.mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "throwaway_traced_steps", "unit": "steps",
                               "better": "higher", "source": "device_trace", "layer": "device",
                               "moves": "products_per_s", "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    script = textwrap.dedent("""
        import json, pathlib, torch
        from nttbench import harness
        assert pathlib.Path(harness.__file__).resolve().is_relative_to(pathlib.Path.cwd().resolve())
        for trace in (False, True):
            res = harness.run("throwaway.cell", 5, 0.2, trace, torch.device("cpu"), log=lambda s: None)
            print(json.dumps(res))
    """)
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{REPO}")
    p = subprocess.run([sys.executable, "-c", script], cwd=root, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    plain, traced = (json.loads(line) for line in p.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"products_per_s", "setup_s"}
    assert traced["metrics"]["throwaway_traced_steps"]["value"] >= 10
    for rel, data in before.items():
        assert (root / rel).read_bytes() == data, f"{rel} was edited"
    assert filecmp.cmp(root / "nttbench" / "harness.py", PKG / "harness.py", shallow=False)
