"""repro_torch — the Spindle system ported to PyTorch and CUDA.

A second package beside :mod:`repro` (the JAX/Pallas reference), with the
same module layout and names: ``core/`` holds the protocol (SST
arithmetic, the fused predicate sweep, the discrete-event simulator of
the paper's testbed, the ``Group`` API and its streams, DDS topics) and
the Spindle gradient reductions, ``models/``
and ``configs/`` the dense decoder and the Mamba2 forward, ``serve/`` the
serve plane on the streamed multicast, ``train/``, ``optim/`` and
``data/`` the training plane (train and serve steps, the Trainer,
checkpoints, AdamW, the token pipeline), and ``kernels/`` the
hand-written Hopper kernels in CUDA (the SMC receive sweep, flash
decode, flash attention, the SSD scan, RMSNorm with and without the
residual add, and the int8 quantize pair).  Nothing here imports ``jax``
or ``repro``.

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
    the CPU is used only when the caller names it.  A CUDA device comes
    back with its index (``cuda`` is the current card), so it compares
    equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
