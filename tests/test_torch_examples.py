"""The port's HE demo (python -m ntt_tpu_torch.examples.he_demo) on the CPU,
in-process: the counterpart of tests/test_examples.py's run of
examples/he_demo.py, at its size (m6, two 27-bit channels, batch 2), with
the schoolbook check; its tower's moduli equal to the JAX tower's; and its
default device raising without a card (no fallback to the CPU)."""

import pytest
import torch

from ntt_tpu import rns as jrns
from ntt_tpu_torch.examples import he_demo

DEMO_ARGS = ["--m", "6", "--widths", "27,27", "--batch", "2", "--check"]


def test_he_demo_verifies_on_cpu(capsys):
    res = he_demo.main(DEMO_ARGS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "verified: exact match with the schoolbook negacyclic product" in out
    assert res["checked"] and res["device_ms"] is None
    assert res["moduli"] == jrns.RnsTower(6, q_bits=(27, 27)).moduli
    assert res["product"].shape == (2, 64)


def test_he_demo_self_check_without_check(capsys):
    he_demo.main(["--m", "5", "--widths", "30,20", "--batch", "3", "--device", "cpu"])
    assert "self-check ok" in capsys.readouterr().out


def test_he_demo_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        he_demo.main(DEMO_ARGS)


def test_schoolbook_negacyclic_wraps_with_a_sign():
    # (1 + x) * x^(n-1) = x^(n-1) + x^n = -1 + x^(n-1) in Z[x]/(x^n + 1)
    n = 4
    assert he_demo.schoolbook_negacyclic([1, 1, 0, 0], [0, 0, 0, 1], n) == [-1, 0, 0, 1]
