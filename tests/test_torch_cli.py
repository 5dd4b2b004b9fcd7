"""The port's CLI, ``python -m ntt_tpu_torch {list,correctness}``, on the
CPU: ``list`` names every variant of the registry in the JAX CLI's format,
and ``correctness --device cpu`` runs every variant's plain version on
reference fixtures against the oracle, in-process through ``main()``, as
tests/test_cli.py drives the JAX CLI."""

import re

import pytest

from ntt_tpu import __main__ as jax_cli
from ntt_tpu_torch import __main__ as cli
from ntt_tpu_torch import api


def name_status(line: str) -> tuple[str, str]:
    """(variant, status) of one sweep line."""
    return re.match(r"q=0x[0-9a-f]+ m=\s*\d+ (\S+)\s+(\S+)", line).groups()


def test_list_names_the_registry(capsys):
    """One line a variant, in the JAX CLI's columns."""
    assert cli.main(["list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines[1:]] == sorted(api.variants())
    assert jax_cli.cmd_list(None) == 0
    assert lines[0] == capsys.readouterr().out.splitlines()[0]
    mxu_line = next(ln for ln in lines if ln.startswith("mxu "))
    assert mxu_line.split()[1:4] == ["yes", "yes", "2^28"]


@pytest.mark.parametrize("fixtures", ["0", "1"])
def test_correctness_on_cpu(capsys, fixtures):
    """Every variant capable at the fixture's q: OK (none is refused at
    m8 / m9), FAILURES: 0, exit 0."""
    assert cli.main(["correctness", "--fixtures", fixtures, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "FAILURES: 0"
    rows = [name_status(ln) for ln in out[:-1]]
    assert all(status in ("OK", "SKIP") for _, status in rows)
    assert sorted(n for n, _ in rows) == sorted(api.variants())  # each takes a 13 / 17-bit q


def test_correctness_skips_what_the_port_refuses(capsys):
    """pallas-fused beyond one block (fixture 15, m15 at word 64) prints
    SKIP with _pick's reason and is no failure; --skip drops variants."""
    skip = ",".join(sorted(set(api.variants()) - {"pallas-fused", "mxu", "radix2"}))
    assert cli.main(["correctness", "--fixtures", "15", "--device", "cpu",
                     "--skip", skip]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [name_status(ln) for ln in out[:-1]] == [("pallas-fused", "SKIP"), ("radix2", "OK")]
    assert "serves m <= 14" in out[0]


def test_default_device_is_cuda():
    """Without a card the default --device cuda raises (no CPU fallback)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["correctness", "--fixtures", "0"])

