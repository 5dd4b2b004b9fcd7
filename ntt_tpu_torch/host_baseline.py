"""The bench's host baseline (``csrc/host_baseline.cpp``) through g++ and ctypes.

At first use, g++ compiles the source with the JAX package's host-core
flags (``-O3 -march=native -std=c++17 -fPIC -shared``) into ``build/``,
under a name that hashes the source, the flags and this host's CPU (the
model and feature flags of ``/proc/cpuinfo``), so a library built for one
CPU is never loaded on another.  ``available()`` says whether the build
and the load succeed; the other functions raise where they do not, with
g++'s output.  No CUDA is involved: this is the single-core CPU transform
that ``bench``'s ``vs_baseline`` divides by.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "host_baseline.cpp"
BUILD = pathlib.Path(__file__).resolve().parent / "build"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_U64P = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")


def _cpu_identity() -> str:
    """This host's CPU model and feature flags, what -march=native reads."""
    try:
        info = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        return f"{platform.machine()} {platform.processor()}"
    keep = [ln for ln in info.splitlines() if ln.split(":")[0].strip() in ("model name", "flags")]
    return "\n".join(sorted(set(keep))) or platform.machine()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_identity().encode())
    return BUILD / f"libhost_baseline_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the source unless this host's library of it exists."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the host baseline needs a C++ compiler on PATH")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded library (built at first call)."""
    cdll = ctypes.CDLL(str(build()))
    u64 = ctypes.c_uint64
    cdll.host_fwd_lazy64.argtypes = [_U64P, u64, u64, _U64P, _U64P, ctypes.c_int]
    cdll.host_fwd_lazy64.restype = None
    cdll.host_bench_fwd_lazy64.argtypes = [u64, u64, u64, ctypes.c_int, ctypes.c_int]
    cdll.host_bench_fwd_lazy64.restype = ctypes.c_double
    return cdll


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        lib()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def fwd_lazy64(a: np.ndarray, q: int, w: np.ndarray, w_con: np.ndarray,
               strict: bool = True) -> np.ndarray:
    """The forward NTT of one polynomial (uint64, values below q): natural
    order in, bit-reversed out, below 4q, or in [0, q) with strict; w /
    w_con the bit-reversed power table and its word-64 Shoup constants."""
    buf = np.ascontiguousarray(a, dtype=np.uint64).copy()
    w = np.ascontiguousarray(w, dtype=np.uint64)
    w_con = np.ascontiguousarray(w_con, dtype=np.uint64)
    if buf.ndim != 1 or buf.size & (buf.size - 1) or w.shape != buf.shape \
            or w_con.shape != buf.shape:
        raise ValueError(f"expected one polynomial of 2^m words and tables of its size, got "
                         f"{buf.shape}, {w.shape}, {w_con.shape}")
    lib().host_fwd_lazy64(buf, buf.size, q, w, w_con, 1 if strict else 0)
    return buf


def bench_fwd_lazy64_ns(m: int, q: int, root: int, inner: int = 100, reps: int = 10) -> float:
    """Nanoseconds per lazy forward transform at N = 2^m on one CPU core:
    10 warm-up transforms, then the minimum over reps of the mean of inner."""
    return float(lib().host_bench_fwd_lazy64(m, q, root, inner, reps))
