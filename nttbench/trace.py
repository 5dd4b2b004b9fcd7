"""Reduce a ``torch.profiler`` trace of the traced steps to the records
the per-layer metrics read.

The traced window runs from the start of the first ``nttbench.step``
annotation to the end of the last.  Within it: the device operations
(kernels, copies, fills) and, on each of the cell's cards, the union of
its own operations' intervals (the profiler's ``args["device"]``, or a
copy between cards' ``inDevice``; an event with neither is card 0's),
whose mean over the cards is the busy
time, a card with no operation idle all through; the device
seconds of each kernel group (kernel-name patterns, one data file a group
in ``kernel_groups/``; a kernel that matches two groups is an error) and
of the kernels that match no group; the kernel launches a step (the
median over the steps: a kernel counts in the step whose interval holds
its launch call); the device operations that took most time; and each
card's idle gaps, cut at the steps' phases, summed by what the host
thread that ran the steps was doing at the middle of each piece, over the
cards and divided by their number, so that a share of the window means
the same on any number of cards.  Device seconds (the groups, the kernels
in no group, the operations) and the launches are summed over the cards.
"""

from __future__ import annotations

import bisect
import json
import pathlib
import re
import statistics

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP = "nttbench.step"
WARMUP = "nttbench.warmup"
PHASES = ("nttbench.issue", "nttbench.sync")
TOP = 10


def kernel_name(raw: str) -> str:
    """A device operation's name without ``void`` and its argument list."""
    name = raw.removeprefix("void ").strip()
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            return name[:i]
    return name


def load_groups(directory: pathlib.Path) -> dict[str, list[re.Pattern]]:
    """{group: compiled patterns} from every ``<group>.json`` in ``directory``."""
    return {f.stem: [re.compile(p) for p in json.loads(f.read_text())["patterns"]]
            for f in sorted(directory.glob("*.json"))}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_labels(host: list[dict], mids: list[float]) -> list[str]:
    """For each time in ``mids`` (ascending), what the host thread was in:
    its innermost event, after the step phase that holds it."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    stack: list[dict] = []
    labels, i = [], 0
    for mid in mids:
        while i < len(host) and host[i]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        phase = next((e["name"].removeprefix("nttbench.") for e in reversed(stack)
                      if e["name"] in PHASES), "between steps")
        inner = re.sub(r"#\d+$", "", stack[-1]["name"]) if stack else ""
        labels.append(f"{phase}: {inner}" if inner and inner not in PHASES + (STEP,)
                      else phase)
    return labels


def _card(event: dict) -> int:
    """The card a device operation ran on: the profiler's ``args["device"]``,
    or for a copy between two cards the one it ran in (``inDevice``); card
    0 where the event names neither."""
    args = event.get("args", {})
    return args.get("device", args.get("inDevice", 0))


def reduce(events: list[dict], groups: dict[str, list[re.Pattern]], cards: int = 1) -> dict:
    """The traced window's records over the cell's ``cards`` cards; seconds
    throughout."""
    steps = sorted((e for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == STEP),
                   key=lambda e: e["ts"])
    if not steps:
        raise ValueError(f"the trace holds no {STEP} annotation")
    w0 = min(e["ts"] for e in steps)
    w1 = max(e["ts"] + e["dur"] for e in steps)
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                dev.append((kernel_name(e["name"]), s, t, _card(e)))
    if any(not 0 <= card < cards for *_, card in dev):
        raise ValueError(f"a device operation outside the cell's {cards} card(s): "
                         f"{sorted({card for *_, card in dev})}")
    busy = [_union([(s, t) for _, s, t, card in dev if card == c]) for c in range(cards)]
    by_name: dict[str, float] = {}
    for name, s, t, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
    group_s = {g: 0.0 for g in groups}
    unmatched: dict[str, float] = {}
    for name, sec in by_name.items():
        hits = [g for g, pats in groups.items() if any(p.search(name) for p in pats)]
        if len(hits) > 1:  # a new group may never take time from an old one
            raise ValueError(f"kernel {name!r} matches more than one group: {hits}")
        if hits:
            group_s[hits[0]] += sec
        else:
            unmatched[name] = sec
    tids = {e.get("tid") for e in steps}
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") in tids
            and "dur" in e]
    # each card's idle gaps, cut where a step phase starts or ends, so that
    # each piece lies in one phase
    cuts = sorted({t for e in host if e["name"] in PHASES for t in (e["ts"], e["ts"] + e["dur"])})
    idle: dict[str, float] = {}
    for card_busy in busy:
        edges = [w0] + [x for iv in card_busy for x in iv] + [w1]
        gaps = []
        for s, t in zip(edges[::2], edges[1::2]):
            inner = cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, t)]
            bounds = [s, *inner, t]
            gaps += [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]
        for (s, t), label in zip(gaps, _host_labels(host, [(s + t) / 2 for s, t in gaps])):
            idle[label] = idle.get(label, 0.0) + (t - s) * 1e-6
    idle = {label: sec / cards for label, sec in idle.items()}
    # a kernel counts in the step whose host interval holds its launch call
    # (matched by the profiler's correlation id), whatever the offset
    # between the host's and the device's clocks
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in host
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    launched = sorted(launch_ts[e["args"]["correlation"]] for e in events
                      if e.get("cat") == "kernel"
                      and e.get("args", {}).get("correlation") in launch_ts)
    per_step = [bisect.bisect_right(launched, e["ts"] + e["dur"])
                - bisect.bisect_left(launched, e["ts"]) for e in steps]
    busy_by_card = [sum(t - s for s, t in b) * 1e-6 for b in busy]
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {
        "steps": len(steps),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(busy_by_card) / cards,
        "busy_by_card_s": busy_by_card,
        "launches": statistics.median(per_step),
        "launches_range": [min(per_step), max(per_step)],
        "group_s": group_s,
        "unmatched_s": unmatched,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
    }
