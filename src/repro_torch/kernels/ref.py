"""Plain oracles for the port's kernels (the ground truth the kernels are
held against): each kernel's plain PyTorch version, under the
reference's ``*_ref`` names."""

from __future__ import annotations

import torch

from repro_torch.core.smc import visible_from_counters
from repro_torch.kernels.flash_decode import \
    flash_decode_plain as flash_decode_ref
from repro_torch.kernels.rmsnorm import rms_norm_plain as rms_norm_ref
from repro_torch.kernels.rmsnorm import \
    rms_norm_residual_plain as rms_norm_residual_ref

__all__ = ["flash_decode_ref", "rms_norm_ref", "rms_norm_residual_ref",
           "smc_sweep_ref"]


def smc_sweep_ref(counters: torch.Tensor,
                  processed: torch.Tensor) -> torch.Tensor:
    """The receive predicate's contiguous scan over an (S, W) ring."""
    w = counters.shape[-1]
    return visible_from_counters(counters, processed, w).to(torch.int32)
