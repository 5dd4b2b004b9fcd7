"""The port's bench harness (``python -m ntt_tpu_torch bench``) on the CPU.

The JSON line's contract against the JAX bench's (its keys, its metric
format, the ``also_batch`` row, ``--tile`` through ``DeviceNtt``), the
suite's table, the watchdog (a subprocess, since it ends with
``os._exit``), the refusal without a card, and the CLI's forwarding; then
the slice against the JAX package: the headline body against
``ntt_tpu.api.fwd_ntt``, every suite body against ``ntt_tpu.refmodel``,
and the host baseline against ``ntt_tpu.native``.  Every comparison is
exact (bit for bit).  In-process runs call ``bench.main`` with
``--device cpu``, where every transform is its plain PyTorch version.
"""

import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ntt_tpu import api as jax_api
from ntt_tpu import native
from ntt_tpu import refmodel as rm
from ntt_tpu.params import bench_params as jax_bench_params
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import __main__ as cli
from ntt_tpu_torch import api, bench, host_baseline, suite_kernels
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.params import bench_params
from ntt_tpu_torch.plan import get_plan

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SMALL = ["--device", "cpu", "--m", "6", "--batch", "4", "--reps", "1"]
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "band_pct", "degraded"}


def json_lines(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def run_main(capsys, *args) -> dict:
    """bench.main in this process: exit 0 and exactly one JSON line."""
    assert bench.main([*SMALL, *args]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 1, lines
    return lines[0]


def test_json_line_has_the_jax_keys_and_metric(capsys):
    """One line with the JAX bench's keys (no degraded once refined) and
    its metric, from the JAX bench's own f-string (bench.py:259-260) on
    the JAX package's params."""
    line = run_main(capsys, "--q-bits", "27")
    assert set(line) <= JAX_KEYS and "degraded" not in line
    p, batch = jax_bench_params(m=6, q_bits=27), 4
    assert line["metric"] == (f"fwd_ntt_transforms_per_sec_N2^{p.m}_"
                              f"q{p.q.bit_length()}bit_batch{batch}")
    assert line["unit"] == "transforms/s" and line["value"] > 0
    assert line["band_pct"] >= 0 and line["vs_baseline"] > 0


def test_also_batch_row(capsys):
    line = run_main(capsys, "--q-bits", "27", "--also-batch", "8")
    assert "batch4" in line["metric"] and line["also_batch8_tps"] > 0
    assert set(line) - JAX_KEYS == {"also_batch8_tps"}


def test_tile_runs_through_device_ntt(capsys, monkeypatch):
    """--tile 2 at q62 times DeviceNtt(p, batch_tile=2).fwd, in tiles; the
    metric still names the whole batch."""
    tiles = []
    fwd = api.DeviceNtt.fwd

    def spy(self, t):
        tiles.append((self._tile, t.shape[0]))
        return fwd(self, t)

    monkeypatch.setattr(api.DeviceNtt, "fwd", spy)
    line = run_main(capsys, "--q-bits", "62", "--tile", "2")
    assert tiles and set(tiles) == {(2, 4)}
    assert "q62bit_batch4" in line["metric"] and line["value"] > 0


def test_suite_header_and_rows(capsys, tmp_path):
    """--suite --only radix2-u32,sixstep-u32 --controls 1: the header (q,
    m, batch, the anchor's readings before, between and after the two rows
    and their band) and exactly those rows."""
    out = tmp_path / "suite.json"
    run_main(capsys, "--q-bits", "27", "--suite", "--suite-json", str(out),
             "--only", "radix2-u32,sixstep-u32", "--controls", "1")
    data = json.loads(out.read_text())
    p = bench_params(6, 27)
    assert (data["q"], data["m"], data["batch"]) == (hex(p.q), 6, 4)
    assert set(data["variants"]) == {"radix2-u32", "sixstep-u32"}
    for row in data["variants"].values():
        assert row["us_per_transform"] > 0 and row["tps"] > 0
    ctl = data["control"]
    assert ctl["name"] == "sixstep-u32" and len(ctl["readings"]) == 3
    assert ctl["band_pct"] >= 0


def test_suite_writes_refused_bodies_with_their_reason(capsys, tmp_path):
    """At q62 the word-32 bodies are refused: by the variant's bound of q,
    or because the API runs the variant at word 64 there."""
    out = tmp_path / "suite.json"
    run_main(capsys, "--q-bits", "62", "--suite", "--suite-json", str(out), "--controls", "0",
             "--only", "radix2-u32,pallas-u32,pallas-u64")
    rows = json.loads(out.read_text())["variants"]
    assert rows["radix2-u32"] == {"skipped": "variant radix2-u32 supports q < 2^30, got "
                                             "62-bit q"}
    assert rows["pallas-u32"] == {"skipped": "a word-32 body: the API runs 'pallas-fused' at "
                                             "word 64 for this 62-bit q"}
    assert rows["pallas-u64"]["us_per_transform"] > 0


def test_watchdog_prints_a_degraded_line_within_the_budget():
    """A wedged run (NTT_BENCH_HANG_S) still exits 0 with one line, marked
    degraded, by the budget's end (3 s, the watchdog's grace 1 s)."""
    code = ("import sys; from ntt_tpu_torch import bench; "
            "sys.exit(bench.main(sys.argv[1:], grace=1.0))")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, *SMALL, "--q-bits", "27", "--budget-s",
                          "3"], cwd=REPO, env=dict(os.environ, NTT_BENCH_HANG_S="600"),
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert time.perf_counter() - t0 < 10
    lines = json_lines(out.stdout)
    assert len(lines) == 1, out.stdout
    assert lines[0]["degraded"] == "budget expired before any measurement"
    assert "N2^6_q27bit_batch4" in lines[0]["metric"]


def test_without_a_card_the_bench_raises():
    """The default --device cuda without a card: a non-zero exit, an
    error, and no JSON line (no line with value 0)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    out = subprocess.run([sys.executable, "-m", "ntt_tpu_torch", "bench", "--m", "6"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert json_lines(out.stdout) == []
    assert "torch.cuda.is_available() is false" in out.stderr


def test_suite_kernels_needs_a_card():
    """The profiler's breakdown of the suite bodies has no CPU form."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        suite_kernels.main(["--m", "6"])


def test_cli_forwards_its_arguments(capsys):
    """python -m ntt_tpu_torch bench -- ARGS runs bench.main(ARGS)."""
    assert cli.main(["bench", "--", *SMALL, "--q-bits", "27", "--m", "5"]) == 0
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == 1 and "N2^5_q27bit_batch4" in lines[0]["metric"]


def test_profile_dir_writes_a_chrome_trace(capsys, tmp_path):
    run_main(capsys, "--q-bits", "27", "--profile-dir", str(tmp_path))
    trace = json.loads((tmp_path / "headline_trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("bits", [27, 62])
@pytest.mark.parametrize("tile", [None, 2])
def test_headline_equals_jax_forward(bits, tile):
    """The headline call on the plain path (batch 4, m6; with --tile 2
    two tiles of 2) equals the JAX package's strict forward."""
    p = bench_params(6, bits)
    x = bench.bench_input(p, 4, CPU)
    got = bench.headline_call(p, tile, CPU)(x)
    a = np.random.default_rng(0).integers(0, p.q, size=(4, p.n), dtype=np.uint64)
    np.testing.assert_array_equal(mm.to_host(x), a)
    np.testing.assert_array_equal(mm.to_host(got),
                                  jax_api.fwd_ntt(a, jax_bench_params(m=6, q_bits=bits)))


def test_every_jax_body_name_is_in_the_suite():
    """SUITE's names are those of the JAX bench's _suite_bodies over both
    widths (bench.py, loaded as a module; nothing of it runs a transform)."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", REPO / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    names = set()
    for bits in (27, 62):
        names |= set(jax_bench._suite_bodies(jax_get_plan(jax_bench_params(m=8, q_bits=bits))))
    assert names == set(bench.SUITE)


# the bodies the port refuses at m8, beyond the word-32 ones at q62
REFUSED = {
    27: {"he-ctmul-u64", "inv-r4r2-u64", "inv-radix4x4-u64", "inv-sixstep-u64",
         "inv-sixstep-unord-u64", "pallas-u64", "r4r2-u64", "radix4x4-u64", "sixstep-rec-u64",
         "sixstep-u64", "sixstep-unord-u64"},
    62: {"inv-r4r2-u64", "inv-radix4-u64", "inv-radix4-w56", "r4r2-u64", "radix4-u64",
         "radix4-vec-u64", "radix4-vec-unord-u64", "radix4-w56"},
}


@pytest.mark.parametrize("bits", [27, 62])
def test_suite_bodies_equal_refmodel(bits):
    """Every suite body the port runs at m8, on its plain path, against
    ntt_tpu.refmodel (proven equal to the JAX package): a forward's strict
    output after its layout's fix equals the Harvey forward; an inverse of
    x equals the Harvey inverse of x read in the variant's layout; he-ctmul
    equals the product of x and x rolled by one row, through the Harvey
    transforms and Python integers.  The refused ones carry a reason."""
    p = bench_params(8, bits)
    plan = get_plan(p)
    bodies = bench.suite_bodies(plan)
    word32 = {n for n, (_, _, w) in bench.SUITE.items() if w == 32} if bits == 62 else set()
    assert {n for n, b in bodies.items() if isinstance(b, str)} == REFUSED[bits] | word32
    a = np.random.default_rng(0).integers(0, p.q, size=(4, p.n), dtype=np.uint64)
    xs = {64: bench.bench_input(p, 4, CPU, wide=True), 32: bench.bench_input(p, 4, CPU)}
    w, wc = plan.w, plan.w_con
    fwd = rm.fwd_ntt_harvey(a, p.q, w, wc)

    def inv(v):
        return rm.inv_ntt_harvey(v, p.q, p.n_inv, plan.n_inv_con, plan.w_inv, plan.w_inv_con)

    for name, body in bodies.items():
        if isinstance(body, str):
            assert body, name
            continue
        fn, word = body
        variant, what, _ = bench.SUITE[name]
        got = fn(xs[word])
        assert got.dtype == xs[word].dtype, name
        got = mm.to_host(got)
        layout = api.output_layout(variant, plan)
        if what == "fwd":
            np.testing.assert_array_equal(layout.fix(got), fwd, err_msg=name)
        elif what == "inv":
            np.testing.assert_array_equal(got, inv(layout.fix(a)), err_msg=name)
        else:
            prod = np.array([[int(u) * int(v) % p.q for u, v in zip(r, s)]
                             for r, s in zip(fwd, np.roll(fwd, 1, axis=0))], dtype=np.uint64)
            np.testing.assert_array_equal(got, inv(prod), err_msg=name)


@pytest.mark.parametrize("strict", [False, True])
def test_host_baseline_equals_jax_native(strict):
    """host_baseline.fwd_lazy64 equals ntt_tpu.native.fwd_lazy64 bit for
    bit at m10 q62 (lazy and strict); strict, the port's radix2 forward."""
    assert host_baseline.available() and native.available()
    p = bench_params(10, 62)
    plan = get_plan(p)
    a = np.random.default_rng(3).integers(0, p.q, size=p.n, dtype=np.uint64)
    got = host_baseline.fwd_lazy64(a, p.q, plan.w, plan.w_con, strict)
    np.testing.assert_array_equal(got, native.fwd_lazy64(a, p.q, plan.w, plan.w_con, strict))
    if strict:
        np.testing.assert_array_equal(got, api.fwd_ntt(a, p, "radix2", device="cpu"))
    else:
        assert int(got.max()) < 4 * p.q


def test_failed_baseline_build_gives_null(capsys, monkeypatch, tmp_path):
    """A g++ that fails: build() raises with its output, and the bench's
    line carries vs_baseline null with the reason on stderr."""
    monkeypatch.setattr(host_baseline, "BUILD", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_baseline.build()

    def refuse(*_, **__):
        raise RuntimeError("g++ failed with exit code 1")

    monkeypatch.setattr(host_baseline, "bench_fwd_lazy64_ns", refuse)
    assert bench.main([*SMALL, "--q-bits", "27"]) == 0
    out = capsys.readouterr()
    lines = json_lines(out.out)
    assert len(lines) == 1 and lines[0]["vs_baseline"] is None and lines[0]["value"] > 0
    assert "no host baseline: g++ failed" in out.err


def test_host_baseline_times_a_transform():
    p = bench_params(10, 62)
    ns = host_baseline.bench_fwd_lazy64_ns(p.m, p.q, p.w, inner=5, reps=2)
    assert math.isfinite(ns) and ns > 0
