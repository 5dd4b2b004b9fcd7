"""Tier guard: the `slow` tier is the list in slow_tier.py and nothing
else, so a test leaves tier-1 only by a line there.

Reads the test files' syntax trees only: no test module and no JAX is
imported, so this runs in well under a second."""

import ast
import pathlib

pytest_plugins = ["slow_tier"]

TESTS = pathlib.Path(__file__).parent


def test_slow_is_registered(pytestconfig):
    names = [m.split(":")[0].strip() for m in pytestconfig.getini("markers")]
    assert "slow" in names, names


def test_no_test_file_marks_slow_itself():
    marked = [path.name for path in sorted(TESTS.glob("test_*.py"))
              for node in ast.walk(ast.parse(path.read_text(), filename=str(path)))
              if isinstance(node, ast.Attribute) and node.attr == "slow"
              and isinstance(node.value, ast.Attribute) and node.value.attr == "mark"]
    assert marked == []


def test_every_slow_case_exists(pytestconfig):
    """Each line of SLOW names a module-level test function, and a case
    that was collected wherever any case of that function was."""
    slow_tier = pytestconfig.pluginmanager.get_plugin("slow_tier")
    seen = pytestconfig.stash.get(slow_tier.SEEN, set())
    funcs = {key.split("[")[0] for key in seen}
    for key in slow_tier.SLOW:
        name, case = key.split("::")
        func = case.split("[")[0]
        tree = ast.parse((TESTS / name).read_text())
        assert func in {fn.name for fn in tree.body if isinstance(fn, ast.FunctionDef)}, key
        if f"{name}::{func}" in funcs:
            assert key in seen, key
