"""Ranks: the port's counterpart of the reference's device mesh.

The reference lays its devices out as a named mesh (``jax.make_mesh``)
and reduces across a mesh axis inside ``shard_map`` (``lax.psum``,
``psum_scatter``, ``all_gather``, ``axis_index``).  Here a rank is one
process holding its own tensors on its own device, and a mesh axis is a
set of ``torch.distributed`` process groups: each holds the ranks that
differ only in that axis's coordinate.

* :class:`RankMesh` -- axis names -> :class:`Axis` (this rank's group on
  the axis, its index there, the axis size), built collectively with
  ``new_group`` from a shape such as ``{"data": 2}`` or ``{"data": 1,
  "model": 2}``.  Ranks lie row-major over the axes, as ``jax.make_mesh``
  lays out devices.  A tuple of axis names in mesh order, such as
  ``("pod", "data")``, names their product (the reference's tuple axis
  names in ``psum`` and ``axis_index``).  A mesh compares equal only to
  itself.
* :func:`all_reduce`, :func:`reduce_scatter`, :func:`all_gather` -- the
  three collectives the port runs (the reference's ``psum``,
  ``psum_scatter`` and ``all_gather``), each over an :class:`Axis`, the
  last two flat or along a dim; :func:`axis_max` is the max over an
  axis, taken from a gather.
* :func:`reduce_from`, :func:`copy_to`, :func:`gather_from`,
  :func:`from_first` -- the collectives autograd sees: a sum whose
  backward hands each rank the cotangent of the sum, its transpose (the
  identity forward, the sum of the cotangents backward), a gather along
  a dim whose backward reduce-scatters, and the value of the axis's
  first rank with each rank's own gradient.  Inside the reference's
  ``shard_map`` they are ``psum`` and its transpose; the port needs them
  spelled out where a rank holds part of a layer (the MoE's experts
  split over ``"model"``, the heads, MLP columns and vocabulary rows of
  tensor parallelism, the FSDP blocks over ``"data"``).
* :func:`reduce_scatter_to`, :func:`split_to`, :func:`gather_whole` --
  those of sequence parallelism, where each rank holds its rows of the
  sequence between the layers: a sum kept as each rank's block (the
  transpose of :func:`gather_from`: its backward gathers), the rank's
  block of a tensor every rank holds whole (its backward gathers), and
  a gather for a computation every rank then runs whole (its backward
  takes the rank's block of the cotangent, which every rank holds
  whole).
* :func:`spawn` -- one process a rank through ``torch.multiprocessing``'s
  ``spawn`` start method (the only one that works once CUDA is up in the
  parent).  Rank ``r`` runs ``fn(r, devices[r], *args)`` and its result
  comes back to the parent.  The parent holds the rendezvous store on
  ``127.0.0.1`` at a port the kernel picks, so concurrent spawns never
  race for a port.  :func:`cards` is the device list of one rank a
  card.
* :func:`init_from_env` -- a ``torchrun`` launch.
* :func:`ledger` -- counts every collective run inside it, by kind,
  operand bytes and group size; on :meth:`RankMesh.ledger`, rank 0 of a
  mesh with no processes behind it, the collectives are counted and not
  run, so that one rank's step runs on ``meta`` tensors and its
  collectives come out as the ranks would run them (the dry-run's).

The backend follows from the devices, here and nowhere else
(:func:`backend_for`): ``nccl`` when every rank has a card of its own
(over NVLink between the cards of one host), ``gloo`` when ranks share a
card or run on the CPU (NCCL refuses two ranks on one card).  ``gloo``
takes CUDA tensors for all three collectives (``all_reduce``,
``reduce_scatter_tensor`` and ``all_gather_into_tensor``, on torch 2.11
with CUDA 12.8 on an H100), so none is staged through host buffers.
NCCL's collectives return before their work is done, queued on streams
of its own that ``torch.cuda.synchronize()`` waits for; a group's
communicator starts on its first collective, which :class:`RankMesh`
runs on every group it builds.  Nothing falls back from one backend to
the other: a rank that cannot start its backend fails the spawn.

With no device named, every entry point wants the card, as
:func:`repro_torch.resolve_device` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import itertools
import math
import os
import queue as queue_mod
import time
import warnings
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import DeviceLike, resolve_device
from repro_torch import tree as tree_util

HOST = "127.0.0.1"
TIMEOUT_S = 600.0


def backend_for(devices: Sequence[DeviceLike]) -> str:
    """``nccl`` when every rank has a CUDA device of its own, else
    ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: the process group of the ranks
    that share every other coordinate with it, its index on the axis (the
    reference's ``lax.axis_index``) and the axis size (``psum(1,
    axis)``).  A product of axes has a tuple for its name."""

    name: Union[str, Tuple[str, ...]]
    group: Any
    index: int
    size: int


class RankMesh:
    """Named axes over the ranks of the default process group.  Every rank
    builds it with the same ``shape`` (``new_group`` is collective); the
    product of the sizes is the world size.  ``device`` is this rank's
    device (the card unless ``"cpu"`` is named).

    Besides each axis, every product of two or more axes in mesh order
    gets its groups here (``("pod", "data")``, ``("data", "model")``, ...):
    a group can only be made by every rank together, so none is made on
    demand.  A mesh of k axes makes ``2**k - 1`` axes' groups; over
    ``nccl`` their communicators start here too."""

    def __init__(self, shape: Mapping[str, int], device: DeviceLike = None):
        if not dist.is_initialized():
            raise RuntimeError("RankMesh needs an initialised default "
                               "process group (spawn, init_from_env)")
        self._set_shape(shape, dist.get_world_size())
        self.device = resolve_device(device)
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        grid = np.arange(self.world_size).reshape(self.sizes)
        coords = np.unravel_index(self.rank, self.sizes)
        for key, dims in self._products():
            along = tuple(self.sizes[i] for i in dims)
            size = math.prod(along)
            # the named dims last, row-major: a line is one group, in the
            # order new_group ranks its members (ascending)
            rest = [i for i in range(len(self.sizes)) if i not in dims]
            lines = grid.transpose(rest + list(dims)).reshape(-1, size)
            mine = None
            # every rank creates every group of the axis, in one order
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    mine = group
            index = int(np.ravel_multi_index(
                tuple(coords[i] for i in dims), along))
            self.axes[key] = Axis(key, mine, index, size)
        if self.backend == "nccl":
            # NCCL starts a group's communicator on its first collective:
            # start the default group's and each of this rank's now, every
            # rank in one order, so that no step carries their start-up
            one = torch.zeros(1, device=self.device)
            dist.all_reduce(one)
            for axis in self.axes.values():
                dist.all_reduce(one, group=axis.group)
            torch.cuda.synchronize(self.device)

    @classmethod
    def ledger(cls, shape: Mapping[str, int],
               device: DeviceLike = "meta") -> "RankMesh":
        """Rank 0 of a mesh of ``shape`` with no processes behind it:
        every axis's group is a :class:`LedgerGroup`, whose collectives
        :func:`ledger` counts and nothing runs (on ``meta`` tensors the
        results have their shapes and no values)."""
        mesh = cls.__new__(cls)
        mesh._set_shape(shape, math.prod(int(v) for v in shape.values()))
        mesh.device = torch.device(device)
        mesh.backend, mesh.rank = "ledger", 0
        for key, dims in mesh._products():
            size = math.prod(mesh.sizes[i] for i in dims)
            mesh.axes[key] = Axis(key, LedgerGroup(size), 0, size)
        return mesh

    def _set_shape(self, shape: Mapping[str, int], world_size: int) -> None:
        self.shape: Dict[str, int] = {str(k): int(v)
                                      for k, v in shape.items()}
        self.sizes = tuple(self.shape.values())
        self.world_size = world_size
        if math.prod(self.sizes) != world_size:
            raise ValueError(f"mesh {self.shape} holds "
                             f"{math.prod(self.sizes)} ranks; the world has "
                             f"{world_size}")
        self.axes: Dict[Union[str, Tuple[str, ...]], Axis] = {}

    def _products(self):
        """``(key, dims)`` of every axis and every product of axes in
        mesh order: one name, or a tuple of names."""
        names = tuple(self.shape)
        for k in range(1, len(names) + 1):
            for dims in itertools.combinations(range(len(names)), k):
                yield (names[dims[0]] if k == 1 else
                       tuple(names[i] for i in dims)), dims

    def axis(self, name: Union[str, Sequence[str]]) -> Axis:
        """The axis ``name``, or for a tuple of names in mesh order their
        product: its index row-major over the named axes (the
        reference's ``lax.axis_index`` of a tuple), its size the
        product of theirs.  A one-name tuple is that axis."""
        key = name if isinstance(name, str) else (
            name[0] if len(name) == 1 else tuple(name))
        if key not in self.axes:
            raise KeyError(f"no mesh axis {name!r}; have {tuple(self.shape)}"
                           " (a product names its axes in mesh order)")
        return self.axes[key]

    def size(self, name: str) -> int:
        """The axis size, 1 for an axis the mesh does not have (the
        reference's ``mesh.shape.get``)."""
        return self.shape.get(name, 1)

    def __repr__(self) -> str:
        return (f"RankMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LedgerGroup:
    """The group of an axis of :meth:`RankMesh.ledger`: its size, and no
    processes."""

    size: int


KIND = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter"}
_ledger: Optional[Dict[Tuple[str, int, int], int]] = None


@contextlib.contextmanager
def ledger():
    """Yields a dict that counts every collective run inside:
    ``{(kind, operand bytes, group size): count}``, the kinds
    ``all-reduce``, ``all-gather`` and ``reduce-scatter``, an
    all-reduce's operand its tensor, a gather's and a reduce-scatter's
    their input."""
    global _ledger
    outer, _ledger = _ledger, {}
    try:
        yield _ledger
    finally:
        _ledger = outer


def _call(collective: Callable, *args, **kwargs):
    group = kwargs["group"]
    fake = isinstance(group, LedgerGroup)
    if _ledger is not None:
        operand = args[0] if collective.__name__ == "all_reduce" else args[1]
        key = (KIND[collective.__name__],
               operand.numel() * operand.element_size(),
               group.size if fake else dist.get_world_size(group))
        _ledger[key] = _ledger.get(key, 0) + 1
    if fake:
        return
    with warnings.catch_warnings():
        # the collectives' newer names are not in every torch this runs on
        warnings.simplefilter("ignore", FutureWarning)
        collective(*args, **kwargs)


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis (``psum``), a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    _call(dist.all_reduce, out, group=axis.group)
    return out


def reduce_scatter(x: torch.Tensor, axis: Axis,
                   dim: Optional[int] = None) -> torch.Tensor:
    """``x`` summed over the axis, rank i keeping its block of the sum
    (``psum_scatter``): with ``dim`` None ``x`` is flat (n * L,) and the
    block elements [i L, (i + 1) L) (not tiled); with ``dim`` the block
    is rows [i L, (i + 1) L) of that dim (tiled)."""
    if dim is not None:
        moved = x.movedim(dim, 0)
        if moved.shape[0] % axis.size:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(x.shape)} does not split over "
                             f"{axis.size} ranks")
        out = reduce_scatter(moved.reshape(-1), axis)
        return out.view(moved.shape[0] // axis.size,
                        *moved.shape[1:]).movedim(0, dim)
    if x.dim() != 1 or x.numel() % axis.size:
        raise ValueError(f"reduce_scatter takes a flat tensor of a "
                         f"multiple of {axis.size} elements, got "
                         f"{tuple(x.shape)}")
    out = x.new_empty(x.numel() // axis.size)
    _call(dist.reduce_scatter_tensor, out, x.contiguous(), group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: Axis,
               dim: Optional[int] = None) -> torch.Tensor:
    """Every rank's ``x`` in axis order: stacked ``(n, *x.shape)`` with
    ``dim`` None, else joined along ``dim`` (tiled)."""
    flat = x.reshape(-1).contiguous()
    out = flat.new_empty(axis.size * flat.numel())
    _call(dist.all_gather_into_tensor, out, flat, group=axis.group)
    out = out.view(axis.size, *x.shape)
    if dim is None:
        return out
    return torch.cat(torch.unbind(out), dim=dim)


def axis_max(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The elementwise max of ``x`` over the axis (``pmax``), gathered
    and reduced here, so that the backends need no MAX reduction."""
    return all_gather(x, axis).amax(0)


# ---------------------------------------------------------------------------
# The collectives autograd sees
# ---------------------------------------------------------------------------

class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


class _FromFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_gather(x, axis)[0].clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.axis, ctx.dim), None, None


def reduce_from(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis, whose backward gives each rank the
    cotangent of the sum as its part's (Megatron's ``g``; in the
    reference, ``psum`` inside ``shard_map``)."""
    return _ReduceFrom.apply(x, axis)


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` itself, whose backward sums the ranks' cotangents over the
    axis (Megatron's ``f``, the transpose of :func:`reduce_from`): a
    tensor that every rank holds whole, entering a computation of which
    each rank holds a part."""
    return _CopyTo.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's block of a tensor joined along ``dim`` in axis order,
    whose backward reduce-scatters the cotangent: each rank gets its
    block of the sum over the axis (FSDP's gather of a parameter split
    over ``"data"``; in the reference, what GSPMD inserts for a
    parameter sharded there)."""
    return _GatherFrom.apply(x, axis, dim % x.dim())


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.axis, ctx.dim), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.axis, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.axis.size
        return grad.narrow(ctx.dim, ctx.axis.index * n, n), None, None


def reduce_scatter_to(x: torch.Tensor, axis: Axis, dim: int
                      ) -> torch.Tensor:
    """``x`` summed over the axis, this rank keeping its block of the sum
    along ``dim`` (rows [i L, (i + 1) L)), whose backward gathers the
    ranks' cotangents of their blocks: each rank gets the cotangent of
    the whole sum (Megatron's reduce-scatter into the sequence-parallel
    region; the transpose of :func:`gather_from`)."""
    return _ReduceScatterTo.apply(x, axis, dim % x.dim())


def split_to(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` that every rank of the
    axis holds whole, whose backward gathers the ranks' cotangents of
    their blocks: each rank gets the cotangent of the whole ``x``."""
    if x.shape[dim] % axis.size:
        raise ValueError(f"split_to: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {axis.size} ranks")
    return _SplitTo.apply(x, axis, dim % x.dim())


def gather_whole(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's block joined along ``dim`` in axis order, for a
    computation that every rank of the axis then runs whole: its
    backward takes this rank's block of the cotangent, which every rank
    holds whole (the transpose of :func:`split_to`)."""
    return _GatherWhole.apply(x, axis, dim % x.dim())


def from_first(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The value of the axis's rank 0 on every rank, whose backward
    hands each rank's cotangent to its own ``x`` (what the reference's
    ``shard_map`` returns for an output of spec ``P()`` that differs
    along the axis, with its replication check off)."""
    return _FromFirst.apply(x, axis)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------

def _matmul_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_matmul_flags(flags) -> None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags[:2]
    torch.set_float32_matmul_precision(flags[2])


def _to_cpu(result: Any) -> Any:
    return tree_util.map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x,
        result)


def _entry(rank: int, fn: Callable, devices: List[torch.device], port: int,
           flags, timeout: float, results, args) -> None:
    _set_matmul_flags(flags)
    store = dist.TCPStore(HOST, port, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout))
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # CPU ranks share the host's cores, as under torchrun
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
    dist.init_process_group(backend_for(devices), store=store, rank=rank,
                            world_size=len(devices),
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, device, *args)
        buf = io.BytesIO()
        torch.save(_to_cpu(out), buf)
        results.put((rank, buf.getvalue()))
    finally:
        dist.destroy_process_group()


def cards(n: int) -> List[torch.device]:
    """``cuda:0`` ... ``cuda:n-1``: ``n`` ranks, one a card (``nccl``
    between them).  Raises when fewer than ``n`` cards are present."""
    resolve_device("cuda:0")          # raises without a card
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"{n} ranks one a card need {n} cards; "
                           f"{have} present")
    return [torch.device("cuda", i) for i in range(n)]


def _devices(devices: Optional[Sequence[DeviceLike]]) -> List[torch.device]:
    if devices is None:
        return cards(torch.cuda.device_count())
    if not devices:
        raise ValueError("spawn needs at least one device")
    devs = [resolve_device(d) for d in devices]
    if any(d.type == "cuda" for d in devs):
        have = torch.cuda.device_count()
        missing = sorted({str(d) for d in devs
                          if d.type == "cuda" and d.index >= have})
        if missing:
            raise RuntimeError(f"ranks on {missing}: {have} cards present")
    return devs


def spawn(fn: Callable, devices: Optional[Sequence[DeviceLike]] = None,
          *args, timeout: float = TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in one process a rank, rank ``r``
    on ``devices[r]`` (``None``: one rank a card; ``"cpu"`` entries run on
    the CPU), the default process group initialised with
    :func:`backend_for` of the devices and the parent's float32 matmul
    flags; CPU ranks split the host's cores between them.  ``fn`` must
    be importable by name (a module-level function) and its result
    picklable; tensors in it come back on the CPU.  Returns the results
    in rank order.  A rank that raises or exits nonzero fails
    the call, and so does one that is not done within ``timeout`` seconds
    (also the collectives' timeout); every process started is stopped
    before this returns."""
    devs = _devices(devices)
    n = len(devs)
    store = dist.TCPStore(HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(
        _entry, args=(fn, devs, store.port, _matmul_flags(), timeout,
                      results, args),
        nprocs=n, join=False, start_method="spawn")
    got: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                rank, payload = results.get(timeout=0.2)
                got[rank] = torch.load(io.BytesIO(payload),
                                       weights_only=False)
                continue
            except queue_mod.Empty:
                pass
            # raises ProcessRaisedException / ProcessExitedException for a
            # failed rank; True once every rank has exited cleanly
            if ctx.join(timeout=0) and results.empty():
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks not done within {timeout} s "
                                   f"({sorted(got)} of {n} returned)")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        del store
    missing = sorted(set(range(n)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} exited without a result")
    return [got[r] for r in range(n)]


def init_from_env(device: DeviceLike = None,
                  timeout: float = TIMEOUT_S) -> torch.device:
    """Initialise the default process group of a ``torchrun`` launch
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) and return this rank's device:
    ``cuda:LOCAL_RANK`` modulo the node's cards (ranks then share a card
    only when there are more of them than cards), or the CPU when
    ``device`` names it.  The backend is :func:`backend_for` of the
    node's devices, the same on every node."""
    local = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device is not None and torch.device(device).type == "cpu":
        node = [torch.device("cpu")] * local_world
    else:
        resolve_device(device)        # raises without a card
        cards = torch.cuda.device_count()
        node = [torch.device("cuda", i % cards) for i in range(local_world)]
    device = node[local]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(node), init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout))
    return device
