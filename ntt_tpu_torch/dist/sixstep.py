"""The distributed six-step NTT: one transform of N = N1 * N2 words sharded
over D shards of a mesh axis, on the two-pass kernels K4-K8.

The counterpart of ``ntt_tpu/dist/sixstep.py`` (shard_map and all_to_all
over a JAX mesh).  With the coefficients of a polynomial viewed (N1, N2):

  forward (``dist_fwd_ntt``)
    1. shard d holds lanes [d N2/D, (d + 1) N2/D) of every row;
    2. K4 ``fwd_cols`` on its (N1, N2/D) shard: a column twiddle is the
       same for every lane;
    3. the all-to-all (N1, N2/D) -> (N1/D, N2): shard d receives rows
       [d N1/D, (d + 1) N1/D), the only communication of the transform;
    4. K5 ``fwd_rows`` on that row shard at row0 = d N1/D: row r's twiddle
       base is N1 + row0 + r, the flat transform's;
    5. the output stays sharded over the rows, in the natural layout.
  inverse (``dist_inv_ntt``): K6 ``inv_rows`` at row0, the all-to-all
  back, K7 ``inv_cols`` on N2/D lanes with the whole transform's n^-1.

So every word meets the flat transform's butterflies and twiddles, and
the bits, lazy representatives included, are those of the single-device
'sixstep'.  ``n_chunks`` cuts each all-to-all into chunks, as the JAX
package does: the forward's chunk c takes rows [c cpc, (c + 1) cpc) of each
of the D row blocks, and K5 runs on it at row0 = d N1/D + c cpc; the
inverse's chunks cut the output lanes.  ``dist_negacyclic_mul`` keeps its
forwards in the transposed (N2, N1/D) shard layout through K3 into K6
(three all-to-alls and nothing else), ``dist_rec_fwd_ntt`` /
``dist_rec_inv_ntt`` shard the two-level six-step (K4 on the level-1 plan's
tables, the all-to-all, K8 on the row shard, the level-2 transforms of the
rows), and ``batch_parallel_fwd`` runs whole transforms a shard.

Each all-to-all is a pass of its own on either side: a shard's blocks are
copied into a tensor whose leading dimension is the destination shard, and
the blocks received are copied back into the layout the next kernel reads.

Tracing (``trace.py``): each entry point is a root span
``ntt_tpu_torch.dist.<entry>``; each phase of the exchange, the scatter of
the inputs onto the shards, each all-to-all with its copies on either side
and the gather of the output, is an ``ntt_tpu_torch.exchange.<phase>``
span inside it, beside the kernel spans; ``trace.EXCHANGED[<phase>]``
adds the bytes the phase sends from one shard position to another.  The
whole input and output belong to the home shard (shard 0) in the local
form, so its own slice and piece cross nothing; in the ranks form every
rank holds the whole input (the scatter sends nothing) and sends its
piece of the output to every other rank.

A ``Mesh`` takes one of two forms.  Local: this process holds every shard,
each on a device of its own or several on one card (the counterpart of the
JAX tests' virtual CPU mesh); an all-to-all is tensor slicing and
``torch.stack``, with ``.to()`` where devices differ.  Ranks: one shard a
process of the ``torch.distributed`` world (``init_multihost``: NCCL on
cards, gloo on the CPU); an all-to-all is ``all_to_all_single`` in the
process group of the rank's line along the axis.  Every rank holds the
whole input, takes its shard, and gathers the whole output (the JAX
package's ``_global_rep`` / ``_collect`` contract).  Words travel in the
port's int32 / int64 reps.

Numpy input goes to the mesh's first device and comes back as numpy
uint64; tensors come back as tensors on the input's device.  The entry
points build ``default_mesh(device=device)`` when given no mesh, so numpy
input with the default ``device="cuda"`` raises where there is no card.
The JAX package's pre-broadcast stage stacks (``_dist_tabs``,
``NTT_ROW_TABS`` / ``NTT_COL_TABS``) are XLA workarounds and are not
ported: the kernels read the flat tables.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as tdist

from ntt_tpu_torch import api, trace
from ntt_tpu_torch import modmath as mm
from ntt_tpu_torch.kernels import pointwise, rec, sixstep, twopass
from ntt_tpu_torch.params import NttParams
from ntt_tpu_torch.plan import NttPlan

SCATTER, ALL_TO_ALL, GATHER = (f"{trace.PREFIX}.exchange.{p}"
                               for p in ("scatter", "all_to_all", "gather"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


class _Line:
    """The shards of one line along the transform axis that this process
    holds, in axis order: ``positions`` their coordinates on the axis,
    ``devices`` theirs; ``group`` the ranks form's process group."""

    def __init__(self, size: int, positions: list[int], devices: list[torch.device],
                 group=None):
        self.size, self.positions, self.devices, self.group = size, positions, devices, group

    def all_to_all(self, sends: list[torch.Tensor]) -> list[torch.Tensor]:
        """sends[i]: held shard i's blocks, block j (leading dimension) for
        the shard at position j; returns what each held shard receives,
        block s from the shard at position s."""
        trace.EXCHANGED["all_to_all"] += sum(_nbytes(send) - _nbytes(send[pos])
                                             for send, pos in zip(sends, self.positions))
        if self.group is None:
            return [torch.stack([send[d].to(dev) for send in sends])
                    for d, dev in zip(self.positions, self.devices)]
        recv = torch.empty_like(sends[0])
        tdist.all_to_all_single(recv, sends[0].contiguous(), group=self.group)
        return [recv]


class Mesh:
    """Shards over named axes, row-major (the JAX ``Mesh``'s shape), in one
    of two forms: local (``rank`` None: this process holds every shard,
    shard i on ``devices[i]``) or ranks (shard i is rank i of the
    ``torch.distributed`` world; ``devices`` holds this rank's device, and
    ``groups`` the process group of its line along each axis).  Build one
    with ``default_mesh`` or ``mesh_2d``."""

    def __init__(self, axis_names: tuple[str, ...], sizes: tuple[int, ...],
                 devices: tuple[torch.device, ...], rank: int | None = None,
                 groups: dict | None = None):
        self.axis_names, self.sizes, self.devices = axis_names, sizes, devices
        self.rank, self.groups = rank, groups or {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def home(self) -> torch.device:
        """Where numpy input and its output go: the first device."""
        return self.devices[0]

    def coords(self, index: int) -> dict[str, int]:
        return {a: int(c) for a, c in zip(self.axis_names, np.unravel_index(index, self.sizes))}

    def _index(self, coords: dict[str, int]) -> int:
        return int(np.ravel_multi_index([coords[a] for a in self.axis_names], self.sizes))

    def _line_of(self, index: int, axis: str) -> list[int]:
        """The shards of index's line along axis, in axis order."""
        c = self.coords(index)
        return [self._index({**c, axis: k}) for k in range(self.shape[axis])]

    def lines(self, axis: str) -> list[tuple[list[int], _Line]]:
        """(shard indices, _Line) of every line along axis that this
        process holds a shard of."""
        size = self.shape[axis]
        if self.rank is not None:
            pos = self.coords(self.rank)[axis]
            return [([self.rank], _Line(size, [pos], [self.devices[0]], self.groups[axis]))]
        out = []
        for i in range(self.size):
            if self.coords(i)[axis] == 0:
                members = self._line_of(i, axis)
                out.append((members, _Line(size, list(range(size)),
                                           [self.devices[j] for j in members])))
        return out

    def __repr__(self) -> str:
        form = "local" if self.rank is None else f"rank {self.rank}"
        return f"Mesh({self.shape}, {form}, devices={list(map(str, self.devices))})"


def _local_devices(device) -> list[torch.device]:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is "
                               "false; pass device='cpu' to run the plain PyTorch path")
        if device.index is None:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return [device]


def _make_mesh(axis_names: tuple[str, ...], sizes: tuple, device) -> Mesh:
    if tdist.is_available() and tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
        sizes = tuple(world if s is None else s for s in sizes)
        if math.prod(sizes) != world:
            raise ValueError(f"a mesh of {sizes} shards in a world of {world} ranks")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if tdist.get_backend() == "nccl" else torch.device("cpu"))
        mesh = Mesh(axis_names, sizes, (dev,), rank)
        # every rank creates every line's group, in the same order
        for axis in axis_names:
            for i in range(world):
                if mesh.coords(i)[axis] == 0:
                    members = mesh._line_of(i, axis)
                    group = tdist.new_group(members)
                    if rank in members:
                        mesh.groups[axis] = group
        return mesh
    devs = _local_devices(device)
    sizes = tuple(len(devs) if s is None else s for s in sizes)
    if min(sizes) < 1:
        raise ValueError(f"mesh sizes must be positive, got {sizes}")
    return Mesh(axis_names, sizes, tuple(devs[i % len(devs)] for i in range(math.prod(sizes))))


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device="cuda") -> None:
    """Join this process to a ``torch.distributed`` world, one shard a
    rank (the JAX ``init_multihost``): NCCL for ``device="cuda"`` (one card
    a rank: this rank's card is ``LOCAL_RANK``, or process_id, modulo the
    cards seen), gloo for ``"cpu"``.  coordinator_address is ``host:port``
    of rank 0; left out, the world comes from the environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them).  After it
    ``default_mesh`` / ``mesh_2d`` span the world."""
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = f"tcp://{coordinator_address}"
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost(device='cuda') but torch.cuda.is_available() "
                               "is false; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
        tdist.init_process_group("nccl", **kw)
    else:
        tdist.init_process_group("gloo", **kw)


def default_mesh(n_devices: int | None = None, axis: str = "x", device="cuda") -> Mesh:
    """A mesh of n_devices shards along ``axis``.  In a ``torch.distributed``
    world, one shard a rank (n_devices, if given, the world size).
    Otherwise local shards on ``device``: on ``"cuda"`` round robin over
    the cards (every shard on one card where there is one; n_devices
    defaults to the number of cards), on ``"cpu"`` all on the CPU (n_devices
    defaults to 1)."""
    return _make_mesh((axis,), (n_devices,), device)


def mesh_2d(n_dp: int, n_sp: int, axes: tuple[str, str] = ("dp", "x"), device="cuda") -> Mesh:
    """A 2-D mesh: a batch axis ('dp', data parallel, no communication) by
    a transform axis ('x'), in either form as ``default_mesh``."""
    return _make_mesh(axes, (n_dp, n_sp), device)


# ---------------------------------------------------------------------------
# sharding and gathering (shard_map's contract)
# ---------------------------------------------------------------------------


def _slices(shape: tuple, spec: tuple, mesh: Mesh, index: int) -> tuple:
    """Shard index's slice of a tensor of ``shape`` sharded by ``spec`` (an
    axis name or None per dim, as a JAX PartitionSpec)."""
    coords = mesh.coords(index)
    out = []
    for size, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
        else:
            step = size // mesh.shape[axis]
            out.append(slice(coords[axis] * step, (coords[axis] + 1) * step))
    return tuple(out)


def _run(mesh: Mesh, axis: str, xs: tuple, in_spec: tuple, out_spec: tuple, fn):
    """fn(line, *shards) on every line along ``axis`` that this process
    holds, shards[k] the contiguous slices of xs[k] (a whole input) by
    in_spec, each on its shard's device; fn's outputs, sharded by out_spec
    and of xs[0]'s shape, assembled into one tensor on xs[0]'s device
    (gathered from every rank in the ranks form)."""
    for a in in_spec + out_spec:
        if a is not None and a not in mesh.shape:
            raise ValueError(f"axis {a!r} not in the mesh {mesh.shape}")
    pieces = {}
    for members, line in mesh.lines(axis):
        with trace.span(SCATTER):
            shards = [[x[_slices(x.shape, in_spec, mesh, i)].to(dev).contiguous()
                       for i, dev in zip(members, line.devices)] for x in xs]
        if mesh.rank is None:
            trace.EXCHANGED["scatter"] += sum(_nbytes(s) for per_x in shards
                                              for i, s in zip(members, per_x) if i != 0)
        pieces.update(zip(members, fn(line, *shards)))
    with trace.span(GATHER):
        out = torch.empty_like(xs[0])
        if mesh.rank is not None:
            (y,) = pieces.values()
            parts = [torch.empty_like(y) for _ in range(mesh.size)]
            tdist.all_gather(parts, y.contiguous())
            trace.EXCHANGED["gather"] += (mesh.size - 1) * _nbytes(y)
            pieces = dict(enumerate(parts))
        else:
            trace.EXCHANGED["gather"] += sum(_nbytes(y) for i, y in pieces.items() if i != 0)
        for i, y in pieces.items():
            view = out[_slices(out.shape, out_spec, mesh, i)]
            view.copy_(y.reshape(view.shape))
    return out


def _input(a, plan: NttPlan, mesh: Mesh):
    """(the rep of a as a (B, N) tensor, a's shape, whether a is numpy)."""
    if isinstance(a, torch.Tensor):
        if a.dtype != plan.dtype:
            raise TypeError(f"expected {plan.dtype} for q={plan.q:#x}, got {a.dtype}")
        t, host = a, False
    else:
        t, host = mm.from_host(a, plan.q, mesh.home), True
    if t.dim() < 1 or t.shape[-1] != plan.n:
        raise ValueError(f"last dim must be N={plan.n}, got shape {tuple(t.shape)}")
    return t.reshape(-1, plan.n), tuple(t.shape), host


def _output(out: torch.Tensor, shape: tuple, host: bool):
    out = out.reshape(shape)
    return mm.to_host(out) if host else out


def _log2(x: int) -> int:
    return x.bit_length() - 1


def _split_for(plan: NttPlan, ndev: int) -> int:
    """The default split: the single-device six-step's (JAX's
    default_split at the plan's width), N1 raised to at least D."""
    return max(sixstep.word_split(plan.n, plan.word), (ndev - 1).bit_length())


def _dims(plan: NttPlan, n1_log: int, ndev: int, row_chunks: int = 1,
          lane_chunks: int = 1) -> tuple[int, int]:
    """(N1, N2) of the split, checked against D shards and the chunks."""
    if not 1 <= n1_log < plan.m:
        raise ValueError(f"n1_log={n1_log} outside [1, {plan.m - 1}] for N=2^{plan.m}")
    n1, n2 = 1 << n1_log, plan.n >> n1_log
    if min(row_chunks, lane_chunks) < 1:
        raise ValueError("n_chunks must be positive")
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"N1={n1}, N2={n2} must both divide by mesh size {ndev}")
    if n1 % (ndev * row_chunks):
        raise ValueError(f"N1={n1} must divide by mesh*chunks = {ndev * row_chunks}")
    if n2 % (ndev * lane_chunks):
        raise ValueError(f"N2={n2} must divide by mesh*chunks = {ndev * lane_chunks}")
    return n1, n2


def _auto(plan: NttPlan, inverse: bool = False) -> api.Variant:
    """The port's 'auto' without its batch rule: pallas-fused within one
    block, the two-pass six-step beyond (never the two-level form, whose
    lazy representatives are its own), as ``api.DeviceNtt`` runs."""
    return api._pick(plan, "auto", inverse)


# ---------------------------------------------------------------------------
# the per-line functions (JAX: local_fn inside shard_map)
# ---------------------------------------------------------------------------


def _fwd_line(line: _Line, shards: list, plan: NttPlan, n1_log: int, n_chunks: int, rows_fn,
              transposed: bool = False, col_plan: NttPlan | None = None) -> list:
    """K4 (on col_plan's tables) on each (B, N1, N2/D) lane shard, the
    all-to-all in n_chunks chunks of rows, and rows_fn(rows, row0,
    rows_log) on each (B, rows * N2) row chunk: (B, N1/D, N2) out, or with
    transposed (rows_fn storing (N2, rows)) (B, N2, N1/D)."""
    d_, n1, n2 = line.size, 1 << n1_log, plan.n >> n1_log
    r, lanes = n1 // d_, n2 // d_
    cpc = r // n_chunks
    cols = [twopass.fwd_cols(s.reshape(s.shape[0], -1), plan, n1_log, col_plan,
                             _log2(lanes)).view(s.shape[0], d_, r, lanes) for s in shards]
    outs: list[list] = [[] for _ in shards]
    for c in range(n_chunks):
        with trace.span(ALL_TO_ALL):
            # (B, D, cpc, N2/D) -> (D, B, cpc, N2/D): block j for the shard at j
            sends = [x[:, :, c * cpc:(c + 1) * cpc].transpose(0, 1).contiguous() for x in cols]
            # block s holds lanes [s N2/D, (s + 1) N2/D): (D, B, cpc, N2/D) -> (B, cpc, N2)
            received = [y.permute(1, 2, 0, 3).reshape(y.shape[1], cpc * n2)
                        for y in line.all_to_all(sends)]
        for out, pos, rows in zip(outs, line.positions, received):
            out.append(rows_fn(rows, pos * r + c * cpc, _log2(cpc)))
    if len(outs[0]) == 1:
        return [out[0] for out in outs]
    if transposed:
        return [torch.cat([o.view(-1, n2, cpc) for o in out], dim=-1) for out in outs]
    return [torch.cat([o.view(-1, cpc, n2) for o in out], dim=1) for out in outs]


def _inv_line(line: _Line, shards: list, plan: NttPlan, n1_log: int, n_chunks: int, rows_fn,
              col_plan: NttPlan | None = None) -> list:
    """rows_fn(shard, row0, rows_log) on each (B, N1/D * N2) row shard
    (natural layout out), the all-to-all in n_chunks chunks of the output
    lanes, and K7 (with col_plan's tables and constants) on each lane
    chunk: (B, N1, N2/D) out."""
    d_, n1, n2 = line.size, 1 << n1_log, plan.n >> n1_log
    r, lanes = n1 // d_, n2 // d_
    cpc = lanes // n_chunks
    rows = [rows_fn(s.reshape(s.shape[0], -1), pos * r, _log2(r)).view(s.shape[0], r, d_, lanes)
            for s, pos in zip(shards, line.positions)]
    outs: list[list] = [[] for _ in shards]
    for c in range(n_chunks):
        with trace.span(ALL_TO_ALL):
            # (B, N1/D, D, cpc) -> (D, B, N1/D, cpc): block j for the shard at j
            sends = [x[..., c * cpc:(c + 1) * cpc].permute(2, 0, 1, 3).contiguous() for x in rows]
            # block s holds rows [s N1/D, (s + 1) N1/D): (D, B, N1/D, cpc) -> (B, N1, cpc)
            received = [y.transpose(0, 1).reshape(y.shape[1], n1 * cpc)
                        for y in line.all_to_all(sends)]
        for out, x in zip(outs, received):
            out.append(twopass.inv_cols(x, plan, n1_log, col_plan, _log2(cpc)).view(-1, n1, cpc))
    return [out[0] if len(out) == 1 else torch.cat(out, dim=-1) for out in outs]


def _k5(plan: NttPlan, n1_log: int, strict: bool, transposed: bool = False):
    return lambda t, row0, rows_log: twopass.fwd_rows(t, plan, n1_log, strict, transposed,
                                                      row0, rows_log)


def _k6(plan: NttPlan, n1_log: int, transposed: bool = False):
    return lambda t, row0, rows_log: twopass.inv_rows(t, plan, n1_log, transposed, row0,
                                                      rows_log)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _setup(a, plan, mesh, axis, batch_axis, device):
    """(plan, mesh, D, the input as a (B, N) rep, its shape, whether numpy)
    of an entry point's arguments; NttParams are taken as api.fwd_ntt
    takes them."""
    plan = api._resolve(plan)
    mesh = default_mesh(axis=axis, device=device) if mesh is None else mesh
    if axis not in mesh.shape or batch_axis == axis:
        raise ValueError(f"transform axis {axis!r}, batch axis {batch_axis!r} on {mesh}")
    x, shape, host = _input(a, plan, mesh)
    if batch_axis is not None and x.shape[0] % mesh.shape[batch_axis]:
        raise ValueError(f"batch {x.shape[0]} must divide by the {batch_axis!r} axis's "
                         f"{mesh.shape[batch_axis]} shards")
    return plan, mesh, mesh.shape[axis], x, shape, host


@trace.traced("dist", "fwd")
def dist_fwd_ntt(a, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                 n1_log: int | None = None, lazy: bool = False, axis: str = "x",
                 batch_axis: str | None = None, n_chunks: int = 1, device="cuda"):
    """Forward NTT of (..., N) values in [0, q) with the transform sharded
    over mesh axis ``axis`` (and with ``batch_axis``, on a ``mesh_2d``, the
    batch data parallel over that axis): bit-reversed output, the flat
    transform's bits (< q, or with lazy its lazy representatives < 4q).
    n_chunks > 1 cuts the all-to-all into chunks of rows."""
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, batch_axis, device)
    n1_log = _split_for(plan, ndev) if n1_log is None else n1_log
    n1, n2 = _dims(plan, n1_log, ndev, row_chunks=n_chunks)
    out = _run(mesh, axis, (x.view(-1, n1, n2),), (batch_axis, None, axis),
               (batch_axis, axis, None),
               lambda line, s: _fwd_line(line, s, plan, n1_log, n_chunks,
                                         _k5(plan, n1_log, not lazy)))
    return _output(out, shape, host)


@trace.traced("dist", "inv")
def dist_inv_ntt(a, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                 n1_log: int | None = None, axis: str = "x", batch_axis: str | None = None,
                 n_chunks: int = 1, device="cuda"):
    """Inverse NTT sharded over mesh axis ``axis`` (strict output); n_chunks
    > 1 cuts the all-to-all into chunks of the output lanes."""
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, batch_axis, device)
    n1_log = _split_for(plan, ndev) if n1_log is None else n1_log
    n1, n2 = _dims(plan, n1_log, ndev, lane_chunks=n_chunks)
    out = _run(mesh, axis, (x.view(-1, n1, n2),), (batch_axis, axis, None),
               (batch_axis, None, axis),
               lambda line, s: _inv_line(line, s, plan, n1_log, n_chunks, _k6(plan, n1_log)))
    return _output(out, shape, host)


@trace.traced("dist", "negacyclic")
def dist_negacyclic_mul(a, b, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                        n1_log: int | None = None, axis: str = "x",
                        batch_axis: str | None = None, n_chunks: int = 1, device="cuda"):
    """Product in R_q[X]/(X^N + 1) with every step sharded: both forwards
    end in K5's transposed (N2, N1/D) shard layout, K3 multiplies there,
    and K6 reads it: three all-to-alls and no other communication."""
    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        raise TypeError("pass both operands as tensors or both as numpy arrays")
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, batch_axis, device)
    y, shape_b, _ = _input(b, plan, mesh)
    if shape_b != shape:
        raise ValueError(f"operands of shapes {shape} and {shape_b}")
    n1_log = _split_for(plan, ndev) if n1_log is None else n1_log
    n1, n2 = _dims(plan, n1_log, ndev, n_chunks, n_chunks)
    spec = (batch_axis, None, axis)

    def line_fn(line, xa, xb):
        fa, fb = (_fwd_line(line, t, plan, n1_log, n_chunks, _k5(plan, n1_log, True, True),
                            transposed=True) for t in (xa, xb))
        prods = [pointwise.mul_mod(u, v, plan.q) for u, v in zip(fa, fb)]
        return _inv_line(line, prods, plan, n1_log, n_chunks, _k6(plan, n1_log, True))

    out = _run(mesh, axis, (x.view(-1, n1, n2), y.to(x.device).view(-1, n1, n2)), spec, spec,
               line_fn)
    return _output(out, shape, host)


def _rec_l1_for(plan: NttPlan, ndev: int) -> int:
    """The rec path's outer split: balanced, N1 raised to at least D."""
    return max(sixstep.rec_split(plan.m), (ndev - 1).bit_length())


@trace.traced("dist", "rec_fwd")
def dist_rec_fwd_ntt(a, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                     l1_log: int | None = None, lazy: bool = False, axis: str = "x",
                     batch_axis: str | None = None, device="cuda"):
    """Forward NTT sharded over ``axis`` through the two-level six-step:
    the level-1 column transforms on N2/D lanes (K4 with the level-1
    plan's tables), one all-to-all, the twist on the row shard (K8), the
    level-2 transforms of the rows ('auto': K1 within one block); strict
    output equal to dist_fwd_ntt's, lazy < 4q."""
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, batch_axis, device)
    l1_log = _rec_l1_for(plan, ndev) if l1_log is None else l1_log
    n1, n2 = _dims(plan, l1_log, ndev)
    plan1, plan2 = plan.rec_plans(l1_log)

    def rows_fn(t, row0, rows_log):  # K8 on the row shard, then level 2 on its rows
        t = rec.twist_mul(t, plan, l1_log, row0=row0, rows_log=rows_log)
        return _auto(plan2).fwd(plan2, t.view(-1, plan2.n), lazy).view(t.shape)

    out = _run(mesh, axis, (x.view(-1, n1, n2),), (batch_axis, None, axis),
               (batch_axis, axis, None),
               lambda line, s: _fwd_line(line, s, plan, l1_log, 1, rows_fn, col_plan=plan1))
    return _output(out, shape, host)


@trace.traced("dist", "rec_inv")
def dist_rec_inv_ntt(a, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                     l1_log: int | None = None, axis: str = "x",
                     batch_axis: str | None = None, device="cuda"):
    """Inverse of dist_rec_fwd_ntt (strict output)."""
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, batch_axis, device)
    l1_log = _rec_l1_for(plan, ndev) if l1_log is None else l1_log
    n1, n2 = _dims(plan, l1_log, ndev)
    plan1, plan2 = plan.rec_plans(l1_log)

    def rows_fn(t, row0, rows_log):  # level 2's inverse on the rows, then K8
        t = _auto(plan2, inverse=True).inv(plan2, t.view(-1, plan2.n)).view(t.shape)
        return rec.twist_mul(t, plan, l1_log, inverse=True, row0=row0, rows_log=rows_log)

    out = _run(mesh, axis, (x.view(-1, n1, n2),), (batch_axis, axis, None),
               (batch_axis, None, axis),
               lambda line, s: _inv_line(line, s, plan, l1_log, 1, rows_fn, col_plan=plan1))
    return _output(out, shape, host)


@trace.traced("dist", "batch_fwd")
def batch_parallel_fwd(a, plan: "NttPlan | NttParams", mesh: Mesh | None = None,
                       axis: str = "x", lazy: bool = False, device="cuda"):
    """The HE-batch mode: the batch sharded over ``axis``, whole forward
    transforms a shard ('auto': K1 within one block, K4 + K5 beyond), no
    communication but the gather."""
    plan, mesh, ndev, x, shape, host = _setup(a, plan, mesh, axis, None, device)
    if len(shape) < 2 or x.shape[0] % ndev:
        raise ValueError(f"batch mode needs a leading batch dim dividing by {ndev}, "
                         f"got shape {shape}")
    out = _run(mesh, axis, (x,), (axis, None), (axis, None),
               lambda line, s: [_auto(plan).fwd(plan, t, lazy) for t in s])
    return _output(out, shape, host)
