"""Spans of the serving path and the one launch counter of the port.

Spans.  Three layers of the serving path each open a span around every
call, named by layer and operation, never by channel or instantiation:

  * ``ntt_tpu_torch.tower.<op>``: a ``rns.DeviceRnsTower`` call
    (``fwd_rep``, ``inv_rep``, ``pointwise_rep``, ``negacyclic``), the
    root of its request;
  * ``ntt_tpu_torch.op.<op>``: an ``api.DeviceNtt`` call (``fwd``, ``inv``,
    ``pointwise``, ``negacyclic``), one a channel of a tower call;
  * ``ntt_tpu_torch.kernel.<wrapper>``: a kernel wrapper (``fwd_fused``,
    ``mul_mod``, ...), from its entry through its checks, its tables, the
    output's allocation, the device context and the stream lookup to the
    return of ``native.launch``: one launch on the card, the plain PyTorch
    version on a CPU tensor.

A span is on only while a profiler records
(``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile``, ``torch.autograd.profiler.profile`` and
``emit_nvtx`` set); otherwise it costs that one flag check.  While on, it
enters ``torch.profiler.record_function``, so that it lands in the
profiler's trace as a ``user_annotation`` (and under ``emit_nvtx`` as an
NVTX range), and records ``Span(name, start_ns, end_ns, parent, root)`` in
a list of at most ``CAPACITY`` spans, on the profiler's clock
(``time.time_ns``: the Chrome trace's ``ts`` in us is it less the trace's
``baseTimeNanoseconds``).  ``parent`` and ``root`` are indices into
``spans()``: -1 for a span with no enclosing one, which is its own root.
Beyond ``CAPACITY`` spans are dropped and counted (``dropped()``);
``reset()`` empties the list.

The launch counter.  ``LAUNCHES`` counts every kernel launch, in
``native.launch``, under its launcher's name less ``ntt_``
(``fwd_fused_u64``, ``r4_stage_solinas_u32``, ``limb_matmul_left_scaled``,
...); beside those, finer counts under keys of their own:
``shard/<launcher>`` for K4-K8 launched on a shard (``kernels/twopass.py``,
``kernels/rec.py``), ``mode/<launcher>/<mode>/<view>`` for each K9 / K10
stage (``kernels/radix2.py``, ``kernels/radix4.py``), and
``fwd_fused_v2_r2_u<w>`` / ``fwd_fused_v2_r4_u<w>`` (with ``_solinas``)
for L1 by its rounds' group (``kernels/fused_lab.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

PREFIX = "ntt_tpu_torch"
CAPACITY = 1 << 17  # 2,000 steps of a 46-span step, and room to spare

LAUNCHES: collections.Counter = collections.Counter()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # index of the enclosing span in spans(), -1 for none
    root: int  # index of the outermost enclosing span (its own where parent is -1)


_records: list = []  # Span by index; None while the span is open
_dropped = 0
_lock = threading.Lock()  # guards _records' length and _dropped
_local = threading.local()  # each thread's open spans: (index, root)
_NULL = contextlib.nullcontext()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "_rf", "_index", "_parent", "_root", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        stack = _stack()
        parent, root = stack[-1] if stack else (-1, -1)
        with _lock:
            if len(_records) < CAPACITY:
                index = len(_records)
                _records.append(None)
            else:
                index = -1
                _dropped += 1
        if index < 0:
            root = -1
        elif parent < 0:
            root = index
        stack.append((index, root))
        self._index, self._parent, self._root = index, parent, root
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        if self._index >= 0:
            _records[self._index] = Span(self.name, self._start, end, self._parent, self._root)
        return self._rf.__exit__(*exc)


def span(name: str):
    """A span named ``name`` while a profiler records, else a shared no-op
    context."""
    return _Span(name) if _profiler._is_profiler_enabled else _NULL


def traced(layer: str):
    """Decorator: each call of the function is a span named
    ``ntt_tpu_torch.<layer>.<the function's name>``."""

    def wrap(fn):
        name = f"{PREFIX}.{layer}.{fn.__name__}"

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def spans() -> list:
    """The recorded spans by index (``None`` for one still open)."""
    return list(_records)


def dropped() -> int:
    """Spans not recorded because the list was full."""
    return _dropped


def reset() -> None:
    """Empty the list and the count of dropped spans; no span may be open."""
    global _dropped
    if _stack():
        raise RuntimeError("trace.reset() with a span open")
    with _lock:
        _records.clear()
        _dropped = 0
