"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

Everything a cell is made of is found by name under the checkout's root:
``BENCHMARK.json`` names the cell's configuration (its file) and traffic
mix; ``nttbench/traffic/<mix>.json`` says which tower entry a step calls,
on how many rows a channel, how many input sets it cycles through and
how many rows a channel the check samples;
``nttbench/entries/<entry>.json`` lists the operations that entry does
in each channel, whose work the rooflines count; the configuration names
the module that builds the system under test
(``nttbench/systems/<system>.py``) and its plain reference
(``nttbench/reference/<reference>.py``); each metric is read by
``nttbench/metrics/<metric>.py`` from this run's records; the kernel
groups that the trace's readers use are ``nttbench/kernel_groups/*.json``.

A cell runs on the ``chips`` cards that ``BENCHMARK.json`` gives it,
``cuda:0`` ... ``cuda:<chips-1>``, from one process: the system is built
on the list of them, inputs are made on the first (the home card), and
every synchronise waits for each of them.

The window is a closed loop with one step in flight, as a caller that
waits for its batch runs it: issue a step, synchronise every card,
repeat until the window's seconds are over.  The host clock times the
window and, in each step, the span from issue to the entry's return.
With trace, a short window under ``torch.profiler`` follows the measured
one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from nttbench import trace as tr
from nttbench import work as wk

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "nttbench"
WARMUP_ROUNDS = 2  # calls of each input set before the window
TRACE_S = 2.0  # the traced window's length, in steps of the measured window's mean
TRACE_STEPS = (10, 2000)
PROFILER_WARMUP = 2  # steps under the profiler before the traced window
FOREIGN = ("jax", "jaxlib", "flax", "ntt_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(root: pathlib.Path, kind: str, name: str):
    """``<root>/nttbench/<kind>/<name>.py``, loaded as a module."""
    path = root / PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{PKG}.{kind}.{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and traffic."""

    root: pathlib.Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def load(cls, name: str, root: pathlib.Path = ROOT) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        workload = next((w for w in bench["workloads"] if w["name"] == name), None)
        if workload is None:
            raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
        entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
        config = json.loads((root / entry["file"]).read_text())
        traffic = json.loads((root / PKG / "traffic" / f"{workload['traffic']}.json").read_text())
        if (traffic["loop"], traffic["in_flight"]) != ("closed", 1):
            raise ValueError(f"traffic {workload['traffic']!r}: this harness runs a closed loop "
                             "with one step in flight")
        return cls(root, bench, workload, config, traffic)

    @property
    def moduli(self) -> list[int]:
        return [int(q, 16) for q in self.config["moduli"]]

    @property
    def n(self) -> int:
        return 1 << self.config["log_n"]

    @property
    def rows(self) -> int:
        return self.traffic["rows_per_channel"]

    def metrics(self, kind: str) -> list[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        name = self.workload["name"]
        return [m for m in self.bench[kind] if name in m.get("workloads", [name])]

    def step_work(self) -> dict[str, wk.Work]:
        entry = self.root / PKG / "entries" / f"{self.traffic['entry']}.json"
        return wk.step_work(self.moduli, self.n, self.rows, json.loads(entry.read_text())["ops"])


def make_inputs(cell: Cell, seed: int, device: torch.device) -> list[tuple[list, list]]:
    """The input sets from ``seed``: each a pair of operands, each a list
    of one (rows, N) tensor a channel with residues below its q, in the
    program's word (int64, or int32 at word 32).  One random draw an
    operand for all channels, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    qs = torch.tensor(cell.moduli, dtype=torch.int64, device=device).view(-1, 1, 1)
    shape = (len(cell.moduli), cell.rows, cell.n)
    sets = []
    for _ in range(cell.traffic["input_sets"]):
        pair = []
        for _ in range(2):
            x = torch.randint(0, 1 << 62, shape, generator=gen, dtype=torch.int64,
                              device=device) % qs
            pair.append([x[c] if wk.word(q) == 64 else x[c].to(torch.int32)
                         for c, q in enumerate(cell.moduli)])
        sets.append(tuple(pair))
    return sets


def cell_devices(home: torch.device, chips: int) -> list[torch.device]:
    """The cell's ``chips`` cards, ``home`` first and the next indices
    after it: ``cuda:0`` ... ``cuda:<chips-1>``.  On the CPU (the tests'
    tiny cells) the host stands in for every card."""
    return [home] + [torch.device(home.type, (home.index or 0) + i) for i in range(1, chips)]


def card_line(devices: list[torch.device]) -> str:
    """'name, power limit' of each card, or the host's device name."""
    if devices[0].type != "cuda":
        return "cpu"
    try:
        return "; ".join(subprocess.run(
            ["nvidia-smi", "--id=" + ",".join(str(d.index or 0) for d in devices),
             "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(devices[0])} (nvidia-smi: {e})"


def memory_peak_bytes(devices: list[torch.device]) -> int:
    """The peak of allocated device memory on the fullest of the cards
    (0 on the CPU)."""
    if devices[0].type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sync_all(devices: list[torch.device]) -> None:
    """Wait for the work of every card of the cell."""
    for d in devices:
        _sync(d)


def window(fn, sets: list, outs: list, seconds: float, devices: list[torch.device]) -> dict:
    """The measured window: closed loop, one step in flight."""
    issue_s = []
    k, w0 = 0, time.perf_counter()
    while True:
        ra, rb = sets[k % len(sets)]
        t0 = time.perf_counter()
        out = fn(ra, rb)
        issue_s.append(time.perf_counter() - t0)
        sync_all(devices)
        t2 = time.perf_counter()
        outs[k % len(sets)] = out
        k += 1
        if t2 - w0 >= seconds:
            break
    return {"steps": k, "window_s": t2 - w0, "host_issue_s": issue_s}


def traced_window(fn, sets: list, outs: list, steps: int, devices: list[torch.device],
                  groups: dict) -> dict:
    """``steps`` steps under ``torch.profiler``, after its own warm-up
    steps (annotated apart, outside the traced window), reduced by
    ``trace.reduce`` over the cell's cards."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if devices[0].type == "cuda"
                                     else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        with profile(activities=acts) as prof:
            for k in range(PROFILER_WARMUP + steps):
                ra, rb = sets[k % len(sets)]
                with record_function(tr.STEP if k >= PROFILER_WARMUP else tr.WARMUP):
                    with record_function(tr.PHASES[0]):
                        out = fn(ra, rb)
                    with record_function(tr.PHASES[1]):
                        sync_all(devices)
                outs[k % len(sets)] = out
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return tr.reduce(events, groups, len(devices))


def sample_rows(cell: Cell, seed: int) -> list[list[np.ndarray]]:
    """Rows the check compares, drawn from ``seed``: for each input set and
    channel, ``sample_rows_per_channel`` distinct rows."""
    rng = np.random.default_rng(seed)
    r = min(cell.traffic["sample_rows_per_channel"], cell.rows)
    return [[np.sort(rng.choice(cell.rows, r, replace=False)) for _ in cell.moduli]
            for _ in range(cell.traffic["input_sets"])]


def check(cell: Cell, picked: list) -> tuple[dict, int]:
    """Compare the sampled outputs with the plain reference's answers on
    the same inputs, channel by channel: (the compared numbers with their
    limits, the sampled products that differ)."""
    ref = load_module(cell.root, "reference", cell.config["reference"])
    entry = cell.traffic["entry"]
    mismatched = compared = bad_rows = 0
    for c, q in enumerate(cell.moduli):
        a, b, got = (torch.cat([p[i][c] for p in picked]) for i in range(3))
        got = got.long()
        diff = ref.product(entry, a, b, q) != got
        mismatched += int(diff.sum())
        bad_rows += int(diff.any(dim=-1).sum())
        compared += got.numel()
    need = (cell.traffic["input_sets"] * len(cell.moduli)
            * min(cell.traffic["sample_rows_per_channel"], cell.rows) * cell.n)
    return {"mismatched_coeffs": {"value": mismatched, "limit": 0, "rule": "at most"},
            "compared_coeffs": {"value": compared, "limit": need, "rule": "at least"}}, bad_rows


def run(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
        root: pathlib.Path = ROOT, system=None,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> dict:
    """One run of cell ``name`` on its cards, ``device`` (the home card)
    first; the result line as a dict.  ``system`` (``build(config,
    devices)``'s signature) replaces the configuration's system under
    test, as the control and the fault tests do."""
    t_enter = time.perf_counter()
    age0 = process_age_s()
    cell = Cell.load(name, root)
    devices = cell_devices(device, cell.workload["chips"])
    build = system or load_module(root, "systems", cell.config["system"]).build
    sut, times = build(cell.config, devices)
    sets = make_inputs(cell, seed, device)
    fn = getattr(sut, cell.traffic["entry"])
    outs: list = [None] * len(sets)
    for k in range(WARMUP_ROUNDS * len(sets)):
        outs[k % len(sets)] = fn(*sets[k % len(sets)])
    sync_all(devices)
    setup_s = age0 + time.perf_counter() - t_enter
    card = card_line(devices)
    log(f"nttbench: {name} seed {seed} on {card}: set-up {setup_s:.3f} s "
        f"(library {times['library_s']:.3f} s, tables {times['tables_s']:.3f} s)")

    rec = {"setup_s": setup_s, **times, "work": cell.step_work(), "chips": len(devices),
           **window(fn, sets, outs, seconds, devices)}
    per_step = cell.rows * len(cell.moduli)  # products a step
    rec["products"] = rec["steps"] * per_step  # in the measured window
    attempted = rec["steps"] * per_step
    if trace:
        mean = rec["window_s"] / rec["steps"]
        n = min(max(math.ceil(TRACE_S / mean), TRACE_STEPS[0]), TRACE_STEPS[1])
        groups = tr.load_groups(root / PKG / "kernel_groups")
        rec["trace"] = traced_window(fn, sets, outs, n, devices, groups)
        attempted += (PROFILER_WARMUP + n) * per_step
        log(f"nttbench: traced {rec['trace']['steps']} steps; kernel launches a step "
            f"{rec['trace']['launches_range']} (least, most); busy s by card "
            f"{rec['trace']['busy_by_card_s']} of {rec['trace']['window_s']}")
        if rec["trace"]["unmatched_s"]:
            print(f"nttbench: device seconds of kernels in no group: "
                  f"{json.dumps(rec['trace']['unmatched_s'])}", flush=True)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = load_module(root, "metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": len(devices),
           "memory_peak_bytes": memory_peak_bytes(devices)}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]

    idx = [[torch.as_tensor(i, device=device) for i in ix] for ix in sample_rows(cell, seed)]
    picked = [tuple([t[c][i] for c, i in enumerate(ix)] for t in (ra, rb, o))
              for (ra, rb), o, ix in zip(sets, outs, idx)]
    del sets, outs, sut, fn
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks, bad_rows = check(cell, picked)
    correct = (checks["mismatched_coeffs"]["value"] <= checks["mismatched_coeffs"]["limit"]
               and checks["compared_coeffs"]["value"] >= checks["compared_coeffs"]["limit"])
    log(f"nttbench: {rec['steps']} steps in {rec['window_s']:.3f} s ("
        f"{1e3 * rec['window_s'] / rec['steps']:.4f} ms a step, issue "
        f"{1e3 * statistics.median(rec['host_issue_s']):.4f} ms median); "
        f"the check took {time.perf_counter() - t0:.3f} s")
    for k, v in checks.items():
        log(f"check {k}: {v['value']} ({v['rule']} {v['limit']})")

    result = {"correct": correct, "attempted": attempted, "failed": bad_rows,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["card"] = card
    result["checks"] = checks
    return result


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
