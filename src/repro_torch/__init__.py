"""repro_torch — the Spindle multicast core ported to PyTorch and CUDA.

A second package beside :mod:`repro` (the JAX/Pallas reference), with the
same module layout and names: ``core/`` holds the protocol (SST
arithmetic, the fused predicate sweep, the ``Group`` API, DDS topics) and
``kernels/`` the hand-written Hopper kernel that evaluates the receive
predicate.  Nothing here imports ``jax`` or ``repro``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
:func:`resolve_device` is the one place that decision is made.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU.  Raises ``RuntimeError`` when a CUDA
    device is asked for (explicitly or by default) and none is present;
    the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
