"""Compare the machine code of this tree's kernels with another tree's.

    python -m ntt_tpu_torch.code_cmp --root DIR [--sources a.cu,b.cu]

Compiles each ``csrc/*.cu`` source (or those named) of this package and of
the package at ``DIR/ntt_tpu_torch`` (a ``git archive`` of another commit)
to an ``sm_90a`` cubin with the package's flags (``native.COMPILE_FLAGS``),
every nvcc started together, then prints for each kernel of either tree
whether its ``.text`` section is byte-identical and its ptxas report
(registers, spills) the same.  Kernels are matched by demangled name with
``(anonymous namespace)::`` removed.  A redesign that must leave other
kernels' code as it was is checked so.  Needs nvcc, cu++filt and the
CUDA toolkit, not a card.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import struct
import subprocess
import tempfile

from ntt_tpu_torch import native

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REPORT = re.compile(r"(\d+ bytes stack frame.*|Used \d+ registers.*)")


def text_sections(cubin: bytes) -> dict[str, bytes]:
    """Mangled kernel name -> bytes of its ``.text.<name>`` section, read
    from the ELF64 section headers."""
    shoff, = struct.unpack_from("<Q", cubin, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", cubin, 0x3A)

    def header(i):
        name, _, _, _, off, size = struct.unpack_from("<IIQQQQ", cubin, shoff + i * shentsize)
        return name, off, size

    _, str_off, _ = header(shstrndx)
    out = {}
    for i in range(shnum):
        name, off, size = header(i)
        end = cubin.index(b"\0", str_off + name)
        sec = cubin[str_off + name:end].decode()
        if sec.startswith(".text."):
            out[sec[len(".text."):]] = cubin[off:off + size]
    return out


def ptxas_reports(log: str) -> dict[str, str]:
    """Mangled kernel name -> its ptxas lines (spills, registers), joined."""
    out, fn = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            fn = m.group(1)
            out[fn] = ""
            continue
        m = _REPORT.search(line)
        if fn and m:
            out[fn] = (out[fn] + "; " if out[fn] else "") + m.group(1).strip()
    return out


def build(csrc: pathlib.Path, names: list[str], out: pathlib.Path) -> dict[str, tuple]:
    """name -> (cubin bytes, ptxas log) for each source of csrc, built in
    parallel."""
    nvcc = native.find_nvcc()
    cmds = [[nvcc, *native.COMPILE_FLAGS, "-cubin", "-o", str(out / f"{n}.cubin"),
             str(csrc / n)] for n in names]
    results = native._run(cmds)
    built = {}
    for n, r in zip(names, results):
        if r.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / n}:\n{r.stdout}")
        built[n] = ((out / f"{n}.cubin").read_bytes(), r.stdout)
    return built


def demangle(names: list[str]) -> dict[str, str]:
    """Mangled -> demangled through cu++filt, anonymous namespaces removed."""
    filt = str(pathlib.Path(native.find_nvcc()).with_name("cu++filt"))
    res = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         check=True, timeout=120).stdout.splitlines()
    return {m: d.replace("(anonymous namespace)::", "") for m, d in zip(names, res)}


def kernels(built: dict[str, tuple]) -> dict[str, tuple]:
    """Demangled kernel name -> (source, .text bytes, ptxas report)."""
    raw = {}
    for src, (cubin, log) in built.items():
        reports = ptxas_reports(log)
        for name, text in text_sections(cubin).items():
            raw[name] = (src, text, reports.get(name, ""))
    names = demangle(sorted(raw))
    return {names[k]: v for k, v in raw.items()}


def compare(root: pathlib.Path, names: list[str] | None = None) -> list[dict]:
    """One row a kernel of either tree: its name, source, whether its
    .text is identical and its ptxas report the same, and both reports."""
    other = root / "ntt_tpu_torch" / "csrc"
    names = names or sorted(p.name for p in native.CSRC.glob("*.cu"))
    native.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD) as tmp:
        (pathlib.Path(tmp) / "a").mkdir()
        (pathlib.Path(tmp) / "b").mkdir()
        here = kernels(build(native.CSRC, names, pathlib.Path(tmp) / "a"))
        there = kernels(build(other, [n for n in names if (other / n).is_file()],
                              pathlib.Path(tmp) / "b"))
    rows = []
    for k in sorted(set(here) | set(there)):
        a, b = here.get(k), there.get(k)
        rows.append({"kernel": k, "source": (a or b)[0],
                     "text": "only here" if b is None else "only there" if a is None
                     else "identical" if a[1] == b[1] else "differs",
                     "ptxas": None if a is None or b is None else a[2] == b[2],
                     "here": a and a[2], "there": b and b[2]})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, required=True,
                    help="the other tree (its ntt_tpu_torch/csrc is compiled)")
    ap.add_argument("--sources", type=lambda s: s.split(","), default=None,
                    help="comma list of csrc/*.cu names (default: all)")
    args = ap.parse_args(argv)
    rows = compare(args.root, args.sources)
    for r in rows:
        if r["ptxas"] is False:
            report = f"ptxas {r['there']} -> {r['here']}"
        else:
            report = ("ptxas same: " if r["ptxas"] else "ptxas: ") + (r["here"] or r["there"])
        print(f"  [{r['source']}] {r['kernel']}: .text {r['text']}; {report}", flush=True)
    counts = {t: sum(r["text"] == t for r in rows)
              for t in ("identical", "differs", "only here", "only there")}
    print(f"code_cmp against {args.root}: {counts}", flush=True)
    return rows


if __name__ == "__main__":
    main()
