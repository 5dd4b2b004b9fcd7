"""The slow tier.  Tier-1 runs `pytest tests/ -m 'not slow'`; this plugin
gives the `slow` mark to the cases listed in SLOW and to no others, so the
list is the one place where a test leaves tier-1.  The test files carry
no `slow` mark of their own.

Run the tier with `pytest tests/ -m slow`.  test_tiers.py loads the
plugin, so a run that does not collect test_tiers.py marks nothing."""

import pytest

# file::case, each 30 s or more alone on an empty compile cache, each
# beside the tier-1 test that still runs its mechanism at a smaller size
SLOW = (
    # N = 2^24 and 2^22 on the 8-device CPU mesh; tier-1: test_dist_large_n (2^20)
    "test_dist.py::test_dist_large_n_2_24",
    "test_dist.py::test_dist_large_n_2_22",
    # word 64, m14 on the mesh; tier-1: the q=0x10001,m=10 case
    "test_dist.py::test_dist_negacyclic_mul[q=0x80000001c0001,m=14]",
    # bench.py subprocesses; tier-1: test_bench_also_batch_row (the headline
    # run plus one row) and test_bench_watchdog_emits_json_when_wedged
    "test_bench.py::test_bench_suite_control_rows",
    "test_bench.py::test_bench_tile_flag",
    "test_bench.py::test_bench_emits_single_json_line",
    # radix4x4 at word 64, m14; tier-1: radix4x4 at q=0x1e01,m=8
    "test_variants_new.py::test_family_variants_bitexact[q=0x80000001c0001,m=14-radix4x4]",
    # g = 4 at word 64; tier-1: g = 2 and 3 at word 64, g = 4 at word 32
    "test_kernels_jnp.py::test_sixstep_grouped_stages[(50, 10)-4]",
)

# file::case of every item collected, read by test_tiers.py
SEEN = pytest.StashKey[set]()


@pytest.hookimpl(tryfirst=True)  # before -m deselects
def pytest_collection_modifyitems(config, items):
    seen = config.stash.setdefault(SEEN, set())
    for item in items:
        key = f"{item.path.name}::{item.name}"
        seen.add(key)
        if key in SLOW:
            item.add_marker(pytest.mark.slow)
