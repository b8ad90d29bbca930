"""Device-placement policy for the stacked batch programs.

The batched stacked sweep (:func:`repro_torch.core.sweep.
run_stacked_batch`) is embarrassingly data-parallel over its leading
scenario-grid axis, so a grid of B points can run one chunk a device
instead of one stacked program on a single device.  The port of
``repro.core.placement``: the reference ``shard_map``s the grid over a
mesh; the port splits the grid into one contiguous chunk a device, runs
the program on each chunk on its device, and concatenates the outputs
on the first device.  Grid points are independent, so there is no
cross-chunk communication and every point's result is the unsharded
batch's.

Policy (:func:`shard_count`): shard over the LARGEST device count that
evenly divides the batch; when that is 1 (one device, or an indivisible
batch) callers run today's single-device program.  The devices are the
caller's: a list named explicitly (four ``cpu`` devices, or ``[cuda:0,
cuda:0]``, which runs the chunks one after another on one card), or by
default (:func:`default_devices`) every card present for a group on a
card, as the reference shards over ``jax.devices()``.  The chunks run one
after another from the host: each is queued on its card's stream, so
the cards of a grid overlap only as far as the host queues ahead.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.launch import mesh as mesh_mod

BATCH_AXIS = "data"


def default_devices(device) -> Optional[List[torch.device]]:
    """The devices a grid shards over when the caller names none: every
    card present for a group on a card, ``None`` (the group's own
    device, unsharded) for one on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_count(batch: int, devices: Sequence) -> int:
    """How many devices a B-point grid shards over: the largest count of
    ``devices`` that evenly divides ``batch`` (1 = the single-device
    program).  Deterministic for a given device list."""
    n_dev = len(devices)
    if batch <= 0 or n_dev <= 1:
        return 1
    for d in range(min(n_dev, batch), 0, -1):
        if batch % d == 0:
            return d
    return 1


def batch_mesh(devices: Sequence, n_shards: int) -> mesh_mod.Mesh:
    """A 1-D mesh over the first ``n_shards`` of ``devices``, axis
    :data:`BATCH_AXIS` (the launch plane's data-parallel axis name)."""
    return mesh_mod.make_smoke_mesh(devices=list(devices)[:n_shards])


def shard_over_batch(fn: Callable, devices: Sequence,
                     n_batched_args: int) -> Callable:
    """``fn`` run one chunk a device: the first ``n_batched_args``
    positional tensors are split along their leading axis into
    ``len(devices)`` equal chunks, chunk ``i`` (and every other tensor
    argument, whole) is moved to ``devices[i]``, ``fn`` runs there, and
    each output (a tensor or a tuple of tensors, every one batched) is
    concatenated along its leading axis on ``devices[0]``."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def sharded(*args):
        chunks = [a.chunk(n) for a in args[:n_batched_args]]
        if any(len(c) != n or c[0].shape[0] * n != a.shape[0]
               for c, a in zip(chunks, args)):
            raise ValueError(f"the grid does not split into {n} equal "
                             "chunks")
        outs = []
        for i, dev in enumerate(devices):
            part = [c[i].to(dev) for c in chunks] + [
                a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args[n_batched_args:]]
            outs.append(fn(*part))
        first = devices[0]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat([o.to(first) for o in outs])
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(len(outs[0])))

    return sharded
