"""The lab's kernels (ntt_tpu_torch.kernels.fused_lab: L1, L2;
ntt_tpu_torch.kernels.probes: L3) on the CPU route against the Pallas lab
(tools/pallas_lab.py) in interpret mode, and the lab harness
(python -m ntt_tpu_torch.lab) on the CPU.

At m = 6, batch 8, inputs below 4q made by numpy from a seed, a word-32 q
(NttParams.generate(27, 6)) and a word-64 q (bench_params(6, 62)), both
through from_fields.  Each JAX call runs once (cached per width and
arguments); the cases spread strict / lazy, the two groupings, the kept
transposed layout and the splits n1_log 3 and 2 over the calls, fewer at
word 64, where an interpret-mode call costs several seconds.  Exact
equality throughout."""

import functools
import importlib.util
import pathlib
import struct

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ntt_tpu.kernels import elems as jel
from ntt_tpu.params import NttParams as JNttParams
from ntt_tpu.params import bench_params as jbench_params
from ntt_tpu.plan import get_plan as jax_get_plan
from ntt_tpu_torch import code_cmp, lab, sass
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import fused, fused_lab, pointwise, probes, twopass
from ntt_tpu_torch.params import from_fields
from ntt_tpu_torch.plan import get_plan

REPO = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("pallas_lab", REPO / "tools/pallas_lab.py")
jlab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jlab)

M, BATCH = 6, 8
WIDTHS = {"w32": JNttParams.generate(27, M), "w64": jbench_params(M, 62)}
# (width, group, strict, n1_log): n1_log 3 leaves a radix-2 tail round in
# both phases, 2 none
V2_CASES = [("w32", 1, True, 3), ("w32", 1, False, 2), ("w32", 2, True, 2),
            ("w32", 2, False, 3), ("w64", 1, False, 3), ("w64", 2, True, 2)]
# (width, strict, keep_transposed, n1_log)
V3_CASES = [("w32", True, False, 3), ("w32", False, False, 2), ("w32", True, True, 2),
            ("w64", False, False, 3), ("w64", True, True, 2)]
PROBES = ["copy", "mul", "math", "moves"]


class Width:
    """One width's params on both sides, its input, and the JAX reps."""

    def __init__(self, jp):
        self.jp = jp
        self.plan = get_plan(from_fields(jp))
        self.jplan = jax_get_plan(jp)
        self.jops = jel.U32Ops if self.plan.word == 32 else jel.U64Ops
        self.wc = self.jplan.w_con32 if self.plan.word == 32 else self.jplan.w_con
        rng = np.random.default_rng(30 + self.plan.word)
        self.a = rng.integers(0, 4 * jp.q, size=(BATCH, jp.n), dtype=np.uint64)
        self.rep = self.jops.from_host(self.a)

    def port(self, a=None):
        return mm.from_host(self.a if a is None else a, self.jp.q, "cpu")

    def jhost(self, rep):
        return self.jops.to_host(rep)

    def tables(self, n1_log):
        return self.jplan.pallas_tables(False, n1_log, self.jops.nlimb)


@functools.lru_cache(maxsize=None)
def get_width(name):
    return Width(WIDTHS[name])


@functools.lru_cache(maxsize=None)
def jax_v2(name, group, strict, n1_log, use_scratch=True):
    """One call of the Pallas L1 (each runs once in the module)."""
    w = get_width(name)
    return w.jhost(jlab.fwd_fused_v2(w.rep, w.jops, w.tables(n1_log), w.jp.q, n1_log,
                                     group=group, strict=strict, use_scratch=use_scratch,
                                     interpret=True))


@functools.lru_cache(maxsize=None)
def jax_v3(name, strict, keep_t, n1_log):
    """One call of the Pallas L2, with its Stockham tables."""
    w = get_width(name)
    tabs = jlab.build_tables_v3(w.jplan.w, w.wc, 1 << n1_log, w.jp.n >> n1_log,
                                w.jops.nlimb)
    return w.jhost(jlab.fwd_fused_v3(w.rep, w.jops, tabs, w.jp.q, n1_log, strict=strict,
                                     keep_transposed=keep_t, interpret=True))


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def width(request):
    return get_width(request.param)


@pytest.fixture(scope="module")
def jax_probes(width):
    """The four Pallas probes, with pl.pallas_call in interpret mode for the
    duration of the calls (_diag_call takes no interpret flag)."""
    n1_log = 3
    n1, n2, tabs = 1 << n1_log, width.jp.n >> n1_log, width.tables(n1_log)
    rounds = 2 if width.plan.word == 64 else 6
    calls = {
        "copy": lambda: jlab.diag_copy(width.rep, tabs, n1, n2, BATCH),
        "mul": lambda: jlab.diag_mul(width.rep, tabs, probes.N_MULTS, n1, n2, BATCH),
        "math": lambda: jlab.diag_math(width.rep, width.jops, tabs, width.jp.q, rounds, n1,
                                       n2, BATCH),
        "moves": lambda: jlab.diag_moves(width.rep, tabs, None, n1, n2, BATCH),
    }
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return rounds, {k: width.jhost(f()) for k, f in calls.items()}
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("case", V2_CASES, ids=lambda c: f"{c[0]}-group{c[1]}-"
                         f"{'strict' if c[2] else 'lazy'}-n1_log{c[3]}")
def test_fwd_fused_v2_matches_pallas_lab(case):
    name, group, strict, n1_log = case
    w = get_width(name)
    got = fused_lab.fwd_fused_v2(w.port(), w.plan, n1_log, group, strict)
    np.testing.assert_array_equal(mm.to_host(got), jax_v2(*case))


def test_pallas_lab_scratch_pair_changes_no_bit():
    """use_scratch is a Mosaic live-range lever: the same bits without it,
    so the port has no counterpart."""
    np.testing.assert_array_equal(jax_v2("w32", 2, True, 2, use_scratch=False),
                                  jax_v2("w32", 2, True, 2))


@pytest.mark.parametrize("case", V3_CASES, ids=lambda c: f"{c[0]}-"
                         f"{'strict' if c[1] else 'lazy'}{'-keep_t' if c[2] else ''}"
                         f"-n1_log{c[3]}")
def test_fwd_fused_v3_matches_pallas_lab(case):
    name, strict, keep_t, n1_log = case
    w = get_width(name)
    got = fused_lab.fwd_fused_v3(w.port(), w.plan, n1_log, strict, keep_t)
    np.testing.assert_array_equal(mm.to_host(got), jax_v3(*case))


@pytest.mark.parametrize("probe", PROBES)
def test_probe_matches_pallas_lab(width, jax_probes, probe):
    """The whole batch against the Pallas probe, and a batch of 3 (no
    multiple of a tile) against its first rows."""
    rounds, want = jax_probes
    run = {"copy": probes.diag_copy, "mul": probes.diag_mul,
           "math": lambda x: probes.diag_math(x, width.plan, rounds),
           "moves": probes.diag_moves}[probe]
    np.testing.assert_array_equal(mm.to_host(run(width.port())), want[probe])
    np.testing.assert_array_equal(mm.to_host(run(width.port(width.a[:3]))), want[probe][:3])


def test_l1_l2_equal_k1_and_refuse_bad_arguments(width):
    x = width.port()
    k1 = fused.fwd_fused(x, width.plan, strict=False)
    for n1_log in range(1, M + 1):
        assert torch.equal(fused_lab.fwd_fused_v2(x, width.plan, n1_log, 2, False), k1)
        assert torch.equal(fused_lab.fwd_fused_v3(x, width.plan, n1_log, False), k1)
    with pytest.raises(ValueError):
        fused_lab.fwd_fused_v2(x, width.plan, 3, group=3)
    with pytest.raises(ValueError):
        fused_lab.fwd_fused_v3(x, width.plan, M + 1)
    with pytest.raises(ValueError):
        probes.diag_copy(x[..., :48])


def numpy_mul_chain(a: np.ndarray, word: int) -> np.ndarray:
    """diag_mul's function in numpy: N_MULTS steps x * c + 1 mod 2^32 on
    each 32-bit half of each word, as the words' bit patterns."""
    halves = a.view(np.uint32)  # word 64: (lo, hi) pairs, little-endian
    c = np.uint32(probes.MUL_C)
    for _ in range(probes.N_MULTS):
        halves = halves * c + np.uint32(1)  # uint32 arrays wrap mod 2^32
    return halves.view(a.dtype)


# diag_copy keeps the ids this test had before it took every probe
@pytest.mark.parametrize("probe,word", [
    pytest.param(probe, word, id=str(word) if probe == "copy" else f"{probe}-{word}")
    for probe in PROBES for word in (32, 64)])
def test_copy_and_moves_on_cpu_at_every_m_k1_serves(probe, word):
    """The probes run K1's design point on the card, so they take the m K1
    takes: on the CPU route at every m from 1 to fused.max_logn(word)
    diag_copy / diag_moves are clone() / flip(-1), diag_mul equals a numpy
    uint32 chain and diag_math at 0 rounds gives its input (below 4q) back;
    one m beyond is refused with K1's message."""
    dtype = torch.int32 if word == 32 else torch.int64
    rng = np.random.default_rng(word)
    case = f"u{word}"
    for m in range(1, fused.max_logn(word) + 1):
        a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3, 1 << m))).to(dtype)
        if probe == "copy":
            assert torch.equal(probes.diag_copy(a), a)
        elif probe == "moves":
            assert torch.equal(probes.diag_moves(a), a.flip(-1))
        elif probe == "mul":
            np.testing.assert_array_equal(probes.diag_mul(a).numpy(),
                                          numpy_mul_chain(a.numpy(), word))
        else:
            p = lab.case_params(case, m)
            a = mm.from_host(rng.integers(0, 4 * p.q, size=(3, p.n), dtype=np.uint64), p.q,
                             "cpu")
            assert torch.equal(probes.diag_math(a, get_plan(p), 0), a)
    beyond = torch.zeros((1, 2 << fused.max_logn(word)), dtype=dtype)
    run = {"copy": probes.diag_copy, "mul": probes.diag_mul, "moves": probes.diag_moves,
           "math": lambda x: probes.diag_math(
               x, get_plan(lab.case_params(case, fused.max_logn(word))), 0)}[probe]
    with pytest.raises(ValueError, match="exceeds one block's shared memory"):
        run(beyond)


def test_k1_split_and_bounds_of_the_lab(monkeypatch):
    """K1's split by the probes adds up to K1, and the lab's bounds are
    chip_smoke's (bytes over the memory rate) per transform."""
    import chip_smoke

    split = lab.k1_split(k1=290.5, copy=60.25, moves=140.0, math=120.5)
    assert split == {"memory path": 60.25, "butterflies": 60.25,
                     "exchanges and barriers": 79.75, "twiddle loads and the rest": 90.25}
    assert sum(split.values()) == 290.5
    # warps overlap the parts: a probe can cost more beyond diag_copy than
    # K1 has left, and the last part then comes out negative
    assert lab.k1_split(k1=100.0, copy=40.0, moves=60.0, math=90.0) == {
        "memory path": 40.0, "butterflies": 50.0, "exchanges and barriers": 20.0,
        "twiddle loads and the rest": -10.0}
    monkeypatch.setattr(chip_smoke, "SOLINAS_MULS", {32: 1, 64: 9})  # read from SASS on the card
    for word in (32, 64):
        for kernel, solinas, tw_words in (("diag_copy", False, 0), ("fwd_fused", False, 2),
                                          ("fwd_fused", True, 1)):
            ms, by = chip_smoke.bound(*chip_smoke.kernel_work(kernel, 14, 14, 512, word,
                                                              solinas))
            assert by == "bytes"
            assert lab.bytes_bound_us(word, 14, 512, tw_words) * 512 == pytest.approx(ms * 1e3)


def test_marginal_rates_take_the_differences_of_the_probes_times(monkeypatch):
    """lab.marginal_rates on made-up device times: the 3 N_MULTS extra steps
    on every 32-bit half over diag_mul's extra time, the m extra rounds of
    N/2 butterflies over diag_math's; every call runs (here its plain
    version)."""
    w = get_width("w64")
    x = w.port()
    calls = []

    def fake_us(fn, v, reps, inner):
        calls.append(fn(v))
        return {1: 10.0, 2: 25.0, 3: 30.0, 4: 42.0}[len(calls)]

    monkeypatch.setattr(lab, "cuda_us", fake_us)
    rates = lab.marginal_rates(w.plan, x)
    assert torch.equal(calls[1], probes.plain_mul(x, 4 * probes.N_MULTS))
    assert torch.equal(calls[3], probes.plain_math(x, w.plan, 2 * M))
    halves = BATCH * w.jp.n * 2
    assert rates["mul_us"] == [10.0, 25.0] and rates["math_us"] == [30.0, 42.0]
    assert rates["mul_per_s"] == pytest.approx(3 * probes.N_MULTS * halves / 15e-6)
    assert rates["bfly_per_s"] == pytest.approx(M * w.jp.n // 2 * BATCH / 12e-6)


def test_lab_main_on_cpu_checks_every_candidate_and_launches_nothing(capsys):
    counts = (fused.LAUNCHES, pointwise.LAUNCHES, twopass.LAUNCHES, fused_lab.LAUNCHES,
              probes.LAUNCHES)
    for c in counts:
        for k in c:
            c[k] = 0
    records = lab.main(["--device", "cpu", "--m", "8", "--batch", "8", "--no-time",
                        "--cases", "both"])
    assert [(r["case"], r["name"]) for r in records] == [
        (case, name) for case in ("u32", "u64") for name in lab.CANDIDATES]
    assert all(r["exact"] and r["us_per_transform"] is None for r in records)
    assert all(set(c.values()) == {0} for c in counts)
    out = capsys.readouterr().out
    assert out.count("bit-exact") == 2 * len(lab.CANDIDATES)
    assert out.count("K1's split: not measured") == 2


def test_lab_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lab.main(["--m", "8", "--batch", "8", "--no-time"])


def test_sass_count_reads_a_cuobjdump_listing():
    listing = """
        Function : fwd_bfly_u64
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R4, SR_TID.X ;                /* 0x0000000000047919 */
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;    /* 0x0000000504027225 */
        /*0030*/              @!P0 IADD3 R6, P1, R2, -R7, RZ ;       /* 0x8000000702068210 */
        /*0040*/                   LDG.E.64 R8, desc[UR4][R2.64] ;   /* 0x0000000402087981 */
        /*0050*/                   EXIT ;                            /* 0x000000000000794d */
        /*0060*/                   BRA 0x60;                         /* 0xfffffffc00fc7947 */
        /*0070*/                   NOP;                              /* 0x0000000000007918 */
        Function : none_u64
        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
"""
    got = sass.count(listing)
    assert got == {"fwd_bfly_u64": {"IMAD.WIDE.U32": 1, "IADD3": 1},
                   "none_u64": {"IMAD.MOV.U32": 1}}


def test_sass_inner_loops_finds_the_innermost_bodies():
    """A loop is a branch back to an earlier address; the outer loop that
    holds another is not innermost, and the spin after EXIT is no loop."""
    listing = """
        Function : _ZN3ntt12_GLOBAL__N_115diag_mul_kernelIjLi4ELi512ELi2EEEvPKT_PS2_jii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, desc[UR4][R8.64] ;
        /*0020*/                   IMAD R2, R2, UR6, 0x1 ;
        /*0030*/                   IMAD R3, R3, UR6, 0x1 ;
        /*0040*/                   IADD3 R4, R4, 0x1, RZ ;
        /*0050*/                   ISETP.GE.AND P0, PT, R4, R5, PT ;
        /*0060*/              @!P0 BRA 0x20 ;
        /*0070*/                   IMAD.MOV.U32 R4, RZ, RZ, RZ ;
        /*0080*/              @!P1 BRA 0x10 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
        Function : none_u32
        /*0000*/                   EXIT ;
"""
    loops = sass.inner_loops(listing)
    assert loops == {
        "_ZN3ntt12_GLOBAL__N_115diag_mul_kernelIjLi4ELi512ELi2EEEvPKT_PS2_jii": [
            {"IMAD": 2, "IADD3": 1, "ISETP.GE.AND": 1, "BRA": 1}],
        "none_u32": []}
    assert sass.multiplies(loops[next(iter(loops))][0]) == 2
    assert "diag_mul_kernelIjLi4E" in next(iter(loops))
    assert sass.PROBE_LOOPS["diag_mul_u32"][0] == "diag_mul_kernelIjLi4E"


def test_code_cmp_reads_text_sections_and_ptxas_reports():
    """code_cmp's ELF reader finds each .text.<kernel> section of a made-up
    ELF64 image, and its ptxas reader each entry's registers and spills."""
    names = b"\0.shstrtab\0.text.k1\0.nv.info\0.text.k2\0"
    payload = {b".text.k1": b"\x01\x02\x03", b".text.k2": b"\xff" * 5, b".nv.info": b"x"}
    body, offsets = b"", {}
    for sec, data in payload.items():
        offsets[sec] = 0x40 + len(names) + len(body)
        body += data
    shoff = 0x40 + len(names) + len(body)
    image = bytearray(0x40) + names + body

    def header(name, off, size):
        return struct.pack("<IIQQQQIIQQ", names.index(name + b"\0"), 1, 0, 0, off, size,
                           0, 0, 1, 0)

    image[0x28:0x30] = struct.pack("<Q", shoff)
    image[0x3A:0x40] = struct.pack("<HHH", 64, 5, 1)
    image += bytes(64) + header(b".shstrtab", 0x40, len(names))
    for sec, data in payload.items():
        image += header(sec, offsets[sec], len(data))
    assert code_cmp.text_sections(bytes(image)) == {"k1": b"\x01\x02\x03", "k2": b"\xff" * 5}
    log = """ptxas info    : Compiling entry function '_Z2k1Pj' for 'sm_90a'
ptxas info    : Function properties for _Z2k1Pj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z2k2Pj' for 'sm_90a'
ptxas info    : Used 64 registers, 380 bytes cmem[0]
"""
    assert code_cmp.ptxas_reports(log) == {
        "_Z2k1Pj": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
                   "Used 118 registers, used 1 barriers, 400 bytes cmem[0]",
        "_Z2k2Pj": "Used 64 registers, 380 bytes cmem[0]"}


def test_chip_smoke_bounds_every_lab_kernel():
    """chip_smoke's kernel table finds the work, source and TPU counterpart
    of every kernel the lab launches."""
    import chip_smoke

    for key in (*fused_lab.LAUNCHES, *probes.LAUNCHES, *fused.LAUNCHES):
        base = key.rsplit("_", 1)[0]
        nbytes, _ = chip_smoke.kernel_work(base, 14, 7, 512, 64)
        assert nbytes > 0
        assert base in chip_smoke.SOURCES and base in chip_smoke.REPLACES


def test_lab_times_needs_a_card(monkeypatch, capsys):
    from ntt_tpu_torch import lab_times

    monkeypatch.setattr("sys.argv", ["lab_times.py", "--tag", "cpu"])
    assert lab_times.main() == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
