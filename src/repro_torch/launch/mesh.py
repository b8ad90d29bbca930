"""Mesh layouts the launch tools plan for.

The reference builds ``jax.make_mesh`` meshes (the dry-run over 512
placeholder host devices).  The port's :class:`Mesh` is plain data: the
ordered axis names and sizes, and optionally the devices.  It is not a
``torch.distributed`` ``DeviceMesh``, which needs a process group; the
sharding rules (:func:`repro_torch.models.layers.spec_to_pspec`) and the
dry-run read only its ``shape``.  Constructing one touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's layouts: 16x16 = 256 chips a pod; 2 pods = 512
    chips multi-pod.  No devices: the dry-run plans for the layout."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_smoke_mesh(device=None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D ``data`` mesh: over ``devices`` when given, else over every
    CUDA device present, or over ``[cpu]`` when ``device="cpu"`` is
    asked for."""
    if devices is None:
        if device is not None and torch.device(device).type == "cpu":
            devices = [torch.device("cpu")]
        else:
            from repro_torch import resolve_device
            resolve_device(device)             # raises without a card
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    return Mesh(("data",), (len(devices),), devices)
