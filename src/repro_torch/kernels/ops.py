"""Public wrappers around the port's kernels: what the protocol core
calls.  They adapt caller layouts (a bool validity mask) to the kernels'
strict int32 lane contract; see :mod:`repro_torch.kernels.smc_sweep`."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import smc_sweep as _ss


def smc_sweep(counters: torch.Tensor, processed: torch.Tensor
              ) -> torch.Tensor:
    """Batched receive-predicate sweep over an explicit (S, W) ring."""
    return _ss.smc_sweep(counters, processed)


def smc_sweep_watermark(published: torch.Tensor, processed: torch.Tensor, *,
                        window: int, valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Receive sweep from published watermarks only — the counter ring is
    rebuilt inside the kernel.  The ``kernel`` Group backend's per-round
    receive predicate.  ``valid`` (bool or int) masks padded
    (member, sender) lanes in stacked multi-subgroup execution."""
    if valid is not None:
        valid = valid.to(torch.int32)
    return _ss.smc_sweep_watermark(published, processed, window=window,
                                   valid=valid)
