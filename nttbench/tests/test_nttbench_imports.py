"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from nttbench.tests.conftest import PKG, REPO, make_root

FOREIGN = {"jax", "jaxlib", "flax", "ntt_tpu"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_sources_import_no_jax(path):
    found = _imports(path)
    assert not found & FOREIGN
    if "ntt_tpu_torch" in found:  # only the builders of the system under test
        assert path.parent.name in ("systems", "tests")


def test_reference_sources_import_no_program():
    for path in (PKG / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "torch", "numpy", "math"}, path


def _loaded_after(script: str, cwd) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    got = _loaded_after(f"""
        import json, pathlib, sys, torch
        from nttbench import harness
        harness.run("tiny.bfv.mul", 3, 0.2, True, torch.device("cpu"),
                    root=pathlib.Path({str(root)!r}), log=lambda s: None)
        print(json.dumps({{"foreign": harness.foreign_modules(),
                          "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """, REPO)
    assert got["foreign"] == []
    assert not set(got["tops"]) & FOREIGN
    assert "ntt_tpu_torch" in got["tops"]  # the check compares whole names


def test_the_reference_loads_no_program():
    got = _loaded_after("""
        import json, sys
        from nttbench.reference import rns_product
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """, REPO)
    assert "ntt_tpu_torch" not in got and not set(got) & FOREIGN


def test_foreign_modules_compares_whole_names(monkeypatch):
    from nttbench import harness

    monkeypatch.setitem(sys.modules, "ntt_tpu_torch_like", sys)
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "ntt_tpu.api", sys)
    assert harness.foreign_modules() == ["ntt_tpu.api"]
