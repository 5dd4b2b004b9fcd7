"""Build and load the CUDA kernels of ``csrc/`` through nvcc and ctypes.

At first use, nvcc compiles every ``csrc/*.cu`` of this package for
``sm_90a``, one process per source, all started together, and links the
objects into one shared library with a plain C interface, written to
``build/`` under a name that hashes the sources and flags, so an edited
source builds anew and an unchanged one is loaded as it is.  The library
is loaded with ctypes: pointers and the CUDA stream pass as ``c_void_p``,
counts as ``c_int`` / ``c_longlong``, and 64-bit constants as
``c_uint64``.  A missing nvcc or a failed build raises, with the
compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ARCH_FLAGS + ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_LL = ctypes.c_longlong
_FUSED_FWD = [_P, _P, _P, _P, _U64, _I, _I, _I, _P]
_FUSED_INV = [_P, _P, _P, _P, _U64, _U64, _U64, _U64, _U64, _I, _I, _I, _P]
_MUL_MOD = [_P, _P, _P, _LL, _U64, _P]
_SOLINAS_MUL = [_P, _P, _P, _LL, _I, _I, _P]
_FWD_COLS = [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _P]
_FWD_ROWS = [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_INV_ROWS = [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _I, _I, _P]
_INV_COLS = [_P, _P, _P, _P, _U64, _U64, _U64, _U64, _U64, _I, _I, _I, _I, _I, _P]
_FWD_V2 = [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _I, _P]
_FWD_V3 = [_P, _P, _P, _P, _U64, _I, _I, _I, _I, _I, _P]
_TWIST = [_P, _P, _P, _P, _P, _P, _U64, _I, _I, _I, _P]
_R2_STAGE = [_P, _P, _P, _P, _U64, _LL, _I, _I, _I, _I, _I, _LL, _I, _I, _I, _U64, _U64, _U64,
             _U64, _I, _P]
_R4_STAGE = [_P, _P, _P, _P, _U64, _LL, _I, _I, _I, _I, _I, _I, _LL, _I, _I, _U64, _U64, _P]
_DIAG = [_P, _P, _I, _I, _P]
_DIAG_MUL = [_P, _P, _U64, _I, _I, _I, _P]
_DIAG_MATH = [_P, _P, _P, _P, _U64, _I, _I, _I, _P]
_LIMB_MATMUL = [_P, _P, _P, _P, _P, _U64, _LL, _I, _I, _P]
SIGNATURES = {
    "ntt_fwd_fused_u32": _FUSED_FWD,
    "ntt_fwd_fused_u64": _FUSED_FWD,
    "ntt_inv_fused_u32": _FUSED_INV,
    "ntt_inv_fused_u64": _FUSED_INV,
    "ntt_mul_mod_u32": _MUL_MOD,
    "ntt_mul_mod_u64": _MUL_MOD,
    "ntt_solinas_mul_u32": _SOLINAS_MUL,
    "ntt_solinas_mul_u64": _SOLINAS_MUL,
    **{f"ntt_{k}_u{w}": sig for w in (32, 64)
       for k, sig in (("fwd_cols", _FWD_COLS), ("fwd_rows", _FWD_ROWS),
                      ("inv_rows", _INV_ROWS), ("inv_cols", _INV_COLS),
                      ("twist_mul", _TWIST),
                      ("fwd_fused_v2", _FWD_V2), ("fwd_fused_v3", _FWD_V3),
                      ("diag_copy", _DIAG), ("diag_mul", _DIAG_MUL),
                      ("diag_math", _DIAG_MATH), ("diag_moves", _DIAG),
                      ("r2_stage", _R2_STAGE), ("r4_stage", _R4_STAGE))},
    "ntt_r4_stage_w56": _R4_STAGE,
    **{f"ntt_limb_matmul_{c}{s}": _LIMB_MATMUL for c in ("left", "right")
       for s in ("", "_scaled")},
    # the Solinas instantiations (the NTT_MULMOD=solinas switch): the Shoup
    # entry point's arguments with (e, k) before the stream
    **{f"ntt_{k}_solinas_u{w}": sig[:-1] + [_I, _I, _P] for w in (32, 64)
       for k, sig in (("fwd_fused", _FUSED_FWD), ("inv_fused", _FUSED_INV),
                      ("fwd_cols", _FWD_COLS), ("fwd_rows", _FWD_ROWS),
                      ("inv_rows", _INV_ROWS), ("inv_cols", _INV_COLS),
                      ("twist_mul", _TWIST), ("r2_stage", _R2_STAGE),
                      ("r4_stage", _R4_STAGE), ("fwd_fused_v2", _FWD_V2),
                      ("fwd_fused_v3", _FWD_V3), ("diag_math", _DIAG_MATH))},
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: pathlib.Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register and shared-memory report)


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD / f"libntt_tpu_torch_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, else from ``PATH``."""
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
    )


def _run(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands in parallel; every process has ended on return."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
        return [subprocess.CompletedProcess(c, p.returncode, out)
                for c, p, out in zip(cmds, procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` unless the library of these sources exists."""
    path = library_path()
    if path.exists():
        return BuildResult(path, 0.0, "")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources()]
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    try:
        steps = [[[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                  for src, obj in zip(sources(), objs)],
                 [[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]]]
        log = ""
        for cmds in steps:
            for proc in _run(cmds):
                log += proc.stdout
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                                       f"{' '.join(proc.args)}\n{proc.stdout}")
        os.replace(tmp, path)
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    return BuildResult(path, time.perf_counter() - t0, log)


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    cdll = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.ntt_error_string.argtypes = [ctypes.c_int]
    cdll.ntt_error_string.restype = ctypes.c_char_p
    return cdll


def launch(name: str, *args) -> None:
    """Call launcher ``ntt_<name>`` and raise if the launch was refused."""
    cdll = lib()
    err = getattr(cdll, "ntt_" + name)(*args)
    if err != 0:
        msg = cdll.ntt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err} ({msg})")


def entry(kernel: str, word: int, solinas) -> str:
    """The launcher name (less ``ntt_``) of ``kernel`` at ``word``: its
    Solinas instantiation where ``solinas`` ((e, k) from
    ``modmath.solinas_args``) is set, else its Shoup one."""
    return f"{kernel}_solinas_u{word}" if solinas else f"{kernel}_u{word}"


def route(t) -> str:
    """Where a kernel wrapper sends tensor ``t``: ``"cpu"`` to the plain
    PyTorch version, ``"cuda"`` to the kernel."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensor on unsupported device {t.device}")
    return t.device.type


def stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
